"""The ``bench.py`` corpus and query mix, importable without side effects.

``bench.py`` re-executes the interpreter at import (malloc tuning) and
imports jax, so the port's smoke run and tests cannot import it. This
module carries the same corpus law, seed, vocabulary, segment cache file
and task ranks (``bench.py:57-86,123-172,203-226``):

* Zipf(1.25) token ids over a 30k-term vocabulary, doc lengths uniform in
  [32, 96), seed 42 (the reference's canonical 5M-doc index run);
* 80 queries each of HighTerm (df ranks 2-81), MedTerm (200-279), LowTerm
  (2000-2079), AndHighMed and OrHighMed (pairs of High and Med terms).
"""

from __future__ import annotations

import contextlib
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

VOCAB = 30_000
K = 10
SEED = 42


def build_corpus(num_docs: int, seed: int = SEED):
    """(doc lengths, token ids): Zipf(1.25) clipped to VOCAB, sampled by
    inverse CDF (``bench.py:build_corpus``)."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(32, 96, size=num_docs)
    total = int(lens.sum())
    ranks = np.arange(1, VOCAB + 1, dtype=np.float64)
    pmf = ranks ** -1.25
    try:
        from scipy.special import zeta

        tail = float(zeta(1.25)) - float(pmf.sum())
    except ImportError:  # integral upper bound of the zeta tail
        tail = (VOCAB ** -0.25) / 0.25
    pmf[-1] += max(tail, 0.0)
    cdf = np.cumsum(pmf)
    cdf /= cdf[-1]
    tids = np.searchsorted(cdf, rng.random(total)).astype(np.int64)
    return lens, tids


def build_segment_data(num_docs: int, seed: int = SEED):
    """One "body" field segment over the corpus (``bench.py:138-163``)."""
    from iresearch_tpu.formats.postings import encode_field_postings
    from iresearch_tpu.formats.spec import IndexFeatures
    from iresearch_tpu.index.invert import invert_numpy
    from iresearch_tpu.index.segment import SegmentData

    lens, tids = build_corpus(num_docs, seed)
    doc_of_tok = np.repeat(np.arange(num_docs), lens)
    starts = np.cumsum(lens) - lens
    pos_of_tok = (
        np.arange(len(tids), dtype=np.int64) - np.repeat(starts, lens)
    ).astype(np.uint32)
    inv = invert_numpy(tids, doc_of_tok, pos_of_tok, VOCAB, num_docs)
    present = np.flatnonzero(np.diff(inv.term_ptr) > 0)
    terms_l = [b"t%06d" % t for t in present]
    blob = b"".join(terms_l)
    offs = np.zeros(len(terms_l) + 1, np.uint64)
    offs[1:] = np.cumsum([len(t) for t in terms_l])
    tp = np.concatenate([inv.term_ptr[present], [inv.term_ptr[-1]]])
    fpn = encode_field_postings(
        inv.e_doc, inv.e_freq, tp, blob, offs, inv.norms, inv.pos_flat,
        IndexFeatures.FREQ | IndexFeatures.POS,
    )
    return SegmentData(num_docs, {"body": fpn}, {})


def load_or_build(num_docs: int, cache_dir: Optional[str]):
    """(SegmentData, loaded_from_cache): the segment from ``cache_dir``
    under ``bench.py``'s file name, else built (and written there)."""
    from iresearch_tpu.formats.segment_io import read_segment, write_segment

    path = None
    if cache_dir is not None:
        path = os.path.join(cache_dir, f"seg_{num_docs}_{VOCAB}_v5.bin")
        if os.path.exists(path):
            with open(path, "rb") as f:
                return read_segment(f.read()), True
    data = build_segment_data(num_docs)
    if path is not None:
        os.makedirs(cache_dir, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "wb") as f:
            f.write(write_segment(data))
        os.replace(tmp, path)
    return data, False


def _ranked(sr):
    """(term_at, high, med, low): ``term_at(rank)`` is the body term of that
    df rank; high, med and low are ``bench.py``'s rank bands 2-81,
    200-279 and 2000-2079."""
    fp = sr.data.fields["body"]
    tv = sr.terms("body")
    order = np.argsort(-fp.entries[:, 0].astype(np.int64))

    def term_at(rank):
        return tv[int(order[min(rank, len(order) - 1)])].decode()

    high = [term_at(i) for i in range(2, 82)]
    med = [term_at(i) for i in range(200, 280)]
    low = [term_at(i) for i in range(2000, 2080)]
    return term_at, high, med, low


def task_mix(sr) -> List[Tuple[str, object]]:
    """The 400-query batched mix over reader ``sr`` (``bench.py:203-226``)."""
    from iresearch_tpu.search import filters as F

    _term_at, high, med, low = _ranked(sr)
    tasks = [("HighTerm", F.ByTerm("body", t)) for t in high]
    tasks += [("MedTerm", F.ByTerm("body", t)) for t in med]
    tasks += [("LowTerm", F.ByTerm("body", t)) for t in low]
    tasks += [
        ("AndHighMed", F.And(F.ByTerm("body", h), F.ByTerm("body", m)))
        for h, m in zip(high, med)
    ]
    tasks += [
        ("OrHighMed", F.Or(F.ByTerm("body", h), F.ByTerm("body", m)))
        for h, m in zip(high, med)
    ]
    return tasks


def breadth_tasks(sr) -> List[Tuple[str, object, bool]]:
    """``bench.py``'s single-query breadth categories over reader ``sr``
    as (name, filter, wand) (``bench.py:305-345``): Prefix is a 3-char
    prefix over a rare band, Fuzzy1 an edit distance of 1, both with the
    reference's ``scored_terms_limit=16``; only OrHigh4+WAND runs with
    ``wand=True``; PrefixHot joins from 1M docs up."""
    from iresearch_tpu.search import filters as F

    term_at, high, med, low = _ranked(sr)

    def T(t):
        return F.ByTerm("body", t)

    tasks = [
        ("Phrase", F.ByPhrase("body", [term_at(30), term_at(31)]), False),
        ("AndHighHigh", F.And(T(term_at(3)), T(term_at(5))), False),
        ("AndHighMed", F.And(T(high[1]), T(med[1])), False),
        ("AndHighLow", F.And(T(high[2]), T(low[2])), False),
        ("Prefix", F.ByPrefix("body", "t01", scored_terms_limit=16), False),
        ("Fuzzy1", F.ByEditDistance(
            "body", term_at(50), max_distance=1, scored_terms_limit=16), False),
        ("OrHigh4+WAND", F.Or(*[T(t) for t in high[:4]]), True),
        ("MinMatch2High2Med", F.Or(
            T(high[3]), T(high[4]), T(med[3]), T(med[4]), min_match=2), False),
    ]
    if sr.num_docs >= 1_000_000:
        tasks.append(
            ("PrefixHot", F.ByPrefix("body", "t00", scored_terms_limit=16), False)
        )
    return tasks


def tier_tasks(sr) -> List[Tuple[str, object, Dict[str, object]]]:
    """One query per single-segment tier that decodes postings rows, as
    (tier, filter, planner knobs), for a ``QueryBatch`` with ``wand=True``:

    * fold — a max-merged High or Low disjunction (grid span + sparse group);
    * aux — a Low term or the Phrase category's phrase, on the host;
    * wand — three sparse terms, grid and sort tiers turned off;
    * direct — a lone High term kept sparse, past a lowered dslice bound;
    * join — a Low term driving, a Med term kept sparse and probed;
    * sort, gridmix — Low or Low, High or Low.

    The knobs (``planner_knobs``) hold for that query's plan only."""
    from iresearch_tpu.search import filters as F

    term_at, high, med, low = _ranked(sr)

    def T(t):
        return F.ByTerm("body", t)

    sparse = dict(USE_DENSE_TERMS=False)
    return [
        ("fold", F.Or(T(high[5]), T(low[5]), merge="max"), {}),
        ("aux", F.Or(T(low[6]), F.ByPhrase("body", [term_at(30), term_at(31)])), {}),
        ("wand", F.Or(T(med[6]), T(med[7]), T(low[7])), dict(sparse, SORT_MAX_RATIO=0.0)),
        ("direct", T(high[8]), dict(sparse, DSLICE_PAD=8)),
        ("sort", F.Or(T(low[0]), T(low[1])), {}),
        ("join", F.And(T(med[2]), T(low[3])), sparse),
        ("gridmix", F.Or(T(high[0]), T(low[0])), {}),
    ]


@contextlib.contextmanager
def planner_knobs(**knobs):
    """Set the shared planner's module knobs (``exec/plan.py:69-74``, and
    ``DSLICE_PAD`` of ``index/segment.py``, which only the planner reads
    after the pools are built) for the duration of the block. The plan
    cache key holds no knob, so the cache is cleared on entry and exit."""
    import iresearch_tpu.index.segment as segmod
    from iresearch_tpu_torch._host import plan as planmod
    from iresearch_tpu_torch._host import plancache

    mods = {name: segmod if name == "DSLICE_PAD" else planmod for name in knobs}
    old = {name: getattr(mods[name], name) for name in knobs}
    plancache.clear_plan_cache()
    try:
        for name, value in knobs.items():
            setattr(mods[name], name, value)
        yield
    finally:
        for name, value in old.items():
            setattr(mods[name], name, value)
        plancache.clear_plan_cache()
