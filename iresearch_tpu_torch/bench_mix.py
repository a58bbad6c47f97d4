"""The ``bench.py`` corpus and query mix, importable without side effects.

``bench.py`` re-executes the interpreter at import (malloc tuning) and
imports jax, so the port's smoke run and tests cannot import it. This
module carries the same corpus law, seeds, vocabulary, segment cache files
and task ranks (``bench.py:57-86,118-172,203-226,305-345``):

* Zipf(1.25) token ids over a 30k-term vocabulary, doc lengths uniform in
  [32, 96), seed 42 (the reference's canonical 5M-doc index run); an
  index of several segments gives segment ``si`` the seed ``42 + si``;
* 80 queries each of HighTerm (df ranks 2-81), MedTerm (200-279), LowTerm
  (2000-2079), AndHighMed and OrHighMed (pairs of High and Med terms).

It also holds the exactness gate that the bench and the smoke run apply
to a top-k (``oracle_topk``, ``assert_gate``, ``check_oracle``).
"""

from __future__ import annotations

import contextlib
import os
from collections import Counter
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


def token_stream(num_docs: int, seed: int = SEED):
    """(term ids, doc of token, position of token) of the corpus, in
    (doc asc, pos asc) arrival order: what an inverter takes."""
    lens, tids = build_corpus(num_docs, seed)
    doc_of_tok = np.repeat(np.arange(num_docs), lens)
    starts = np.cumsum(lens) - lens
    pos_of_tok = (
        np.arange(len(tids), dtype=np.int64) - np.repeat(starts, lens)
    ).astype(np.uint32)
    return tids, doc_of_tok, pos_of_tok


def corpus_text(num_docs: int, seed: int = SEED):
    """The corpus as text, for an analyzer and the writer: doc ``d`` is the
    words ``b"t%06d"`` of its token ids joined by spaces (the term
    spelling of ``build_segment_data``). Returns (buffer, starts, ends):
    doc ``d`` is ``buffer[starts[d]:ends[d]]``. Built as one buffer of
    8-byte records ``"t%06d "`` indexed by the token ids."""
    lens, tids = build_corpus(num_docs, seed)
    rec = np.frombuffer(b"".join(b"t%06d " % t for t in range(VOCAB)), np.uint8)
    buf = rec.reshape(VOCAB, 8)[tids].tobytes()
    ends = np.cumsum(lens) * 8
    return buf, ends - lens * 8, ends - 1


def build_segment_data(num_docs: int, seed: int = SEED):
    """One "body" field segment over the corpus (``bench.py:138-163``)."""
    from iresearch_tpu_torch.formats.postings import encode_field_postings
    from iresearch_tpu_torch.formats.spec import IndexFeatures
    from iresearch_tpu_torch.index.invert import invert_numpy
    from iresearch_tpu_torch.index.segment import SegmentData

    tids, doc_of_tok, pos_of_tok = token_stream(num_docs, seed)
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


def segment_path(num_docs: int, cache_dir: str, seg_index: int = 0) -> str:
    """The file of segment ``seg_index`` (seed ``42 + seg_index``) in
    ``cache_dir`` under ``bench.py``'s name (``bench.py:118-130``: segment 0
    keeps the single-segment name, segment ``si`` gets the suffix
    ``_s{42 + si}``): ``write_segment`` bytes."""
    suffix = "" if seg_index == 0 else f"_s{SEED + seg_index}"
    return os.path.join(cache_dir, f"seg_{num_docs}_{VOCAB}_v5{suffix}.bin")


def load_or_build(num_docs: int, cache_dir: Optional[str], seg_index: int = 0):
    """(SegmentData, loaded_from_cache): segment ``seg_index`` of an index
    (seed ``42 + seg_index``) from its file in ``cache_dir``
    (``segment_path``), else built (and written there)."""
    from iresearch_tpu_torch.formats.segment_io import read_segment, write_segment

    seed = SEED + seg_index
    path = None
    if cache_dir is not None:
        path = segment_path(num_docs, cache_dir, seg_index)
        if os.path.exists(path):
            with open(path, "rb") as f:
                return read_segment(f.read()), True
    data = build_segment_data(num_docs, seed)
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
    from iresearch_tpu_torch.search import filters as F

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


def breadth_tasks(sr, num_docs: Optional[int] = None) -> List[Tuple[str, object, bool]]:
    """``bench.py``'s single-query breadth categories over reader ``sr``
    as (name, filter, wand) (``bench.py:305-345``): Prefix is a 3-char
    prefix over a rare band, Fuzzy1 an edit distance of 1, both with the
    reference's ``scored_terms_limit=16``; only OrHigh4+WAND runs with
    ``wand=True``; PrefixHot joins from 1M docs up (the index's
    ``num_docs``, ``sr``'s where None). ``Phrase`` runs on the device under
    the single query's default (``exec/phrase.py``)."""
    from iresearch_tpu_torch.search import filters as F

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
    if (sr.num_docs if num_docs is None else num_docs) >= 1_000_000:
        tasks.append(
            ("PrefixHot", F.ByPrefix("body", "t00", scored_terms_limit=16), False)
        )
    return tasks


def oracle_topk(flt, srs, scorer, k: int):
    """(docs, scores) of ``HostQuery`` over the segments ``srs`` (index-wide
    stats), the matches in (score desc, global doc asc) order, first ``k``:
    the numpy oracle, ordered with numpy instead of a Python loop over
    every match."""
    from iresearch_tpu_torch.search.host_eval import HostQuery

    hq = HostQuery(flt, list(srs), scorer)
    docs, sc, base = [], [], 0
    for s, sr in enumerate(srs):
        r = hq.execute(s)
        d = np.flatnonzero(r.match)
        docs.append(d + base)
        sc.append(r.score[d])
        base += sr.num_docs
    docs, sc = np.concatenate(docs), np.concatenate(sc)
    o = np.lexsort((docs, -sc))[:k]
    return docs[o], sc[o]


def assert_gate(gv, gd, wd, wv, what: str) -> None:
    """The repo's exactness gate (as ``tests/topk_util.py`` applies it) on
    one top-k: (gv, gd) with -inf for non-matches against the matches
    (wd, wv) of a reference in (score desc, doc asc) order: the same
    matches, scores to rtol 1e-5, doc order exact except for swaps inside
    near-ties. Raises ``AssertionError``."""
    gv, gd = np.asarray(gv), np.asarray(gd)
    fin = np.isfinite(gv)
    gd, gv = gd[fin], gv[fin]
    if len(gd) != len(wd):
        raise AssertionError(f"{what}: {len(gd)} vs {len(wd)} hits")
    np.testing.assert_allclose(gv, wv, rtol=1e-5, atol=1e-6, err_msg=what)
    want = dict(zip(wd.tolist(), wv.tolist()))
    for g, w, s in zip(gd.tolist(), wd.tolist(), wv.tolist()):
        if g != w and not (g in want and abs(want[g] - s) <= 1e-5 * abs(s) + 1e-6):
            raise AssertionError(f"{what}: doc {g} vs {w}")


def check_oracle(vals, docs, tasks, srs, scorer, k: int, per_category: int = 5) -> Counter:
    """The first ``per_category`` queries of each category of ``tasks``
    ([(category, filter)]) through the gate: row ``qi`` of ``vals`` and
    ``docs`` (global docs, -inf for non-matches) against ``oracle_topk``
    over ``srs``. Returns the queries checked per category."""
    seen = Counter()
    for qi, (cat, flt) in enumerate(tasks):
        if seen[cat] < per_category:
            seen[cat] += 1
            wd, wv = oracle_topk(flt, srs, scorer, k)
            assert_gate(vals[qi], docs[qi], wd, wv, f"oracle q{qi} {cat}")
    return seen


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
    from iresearch_tpu_torch.search import filters as F

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


def single_tier_tasks(sr) -> Dict[str, Tuple[object, bool, Dict[str, object], bool]]:
    """One query per tier of the single query (``DeviceQuery``) as tier ->
    (filter, wand, planner knobs, device_phrase): the mix's first High
    term under WAND (skyline; on a segment whose grid has fewer than 384
    rows, under 49,152 docs, only with ``exec/skyline.py``'s
    ``SKYLINE_SCAN_RATIO`` lowered) and Low term (dslice), the breadth
    categories MinMatch2High2Med (scan, from 20,000 to 5M docs: AndHighHigh
    takes the skyline at 5M) and Phrase (its rows made on the device:
    "phrase", in the aux tier), and ``tier_tasks`` under WAND (the aux
    query's phrase evaluated on the host)."""
    from iresearch_tpu_torch.search import filters as F

    _term_at, high, _med, low = _ranked(sr)
    breadth = {n: f for n, f, _w in breadth_tasks(sr)}
    out = {
        "skyline": (F.ByTerm("body", high[0]), True, {}, True),
        "scan": (breadth["MinMatch2High2Med"], False, {}, True),
        "dslice": (F.ByTerm("body", low[0]), False, {}, True),
        "phrase": (breadth["Phrase"], False, {}, True),
    }
    for tier, f, kv in tier_tasks(sr):
        out[tier] = (f, True, kv, tier != "aux")
    return out


def task_lines(sr, per_category: int = 5) -> List[str]:
    """A luceneutil task file over reader ``sr``: ``per_category`` lines
    of each of the CLI's 22 categories (``cli/index_search.py``), their
    terms taken from ``sr``'s df ranks (``bench.py``'s High, Med and Low
    bands; HighPhrase pairs df ranks 10-19, which follow each other often
    enough to match in a small corpus). Prefix3 and Wildcard name
    prefixes and patterns of 1,000 rare ``t%06d`` words each (ranks
    10,000-29,999), and Fuzzy terms are rare words too: an edit of a
    ``t%06d`` word's digits reaches the commonest words, whose postings
    the host oracle scores over every doc. The host evaluates an n-gram
    similarity doc by doc, so the NGram lines take their 3 to 4 word
    terms one band lower: Med, ranks 1,000-1,079 and Low."""
    term_at, high, med, low = _ranked(sr)
    out = []
    for i in range(per_category):
        h = high[4 * i : 4 * i + 6]
        m = med[4 * i : 4 * i + 4]
        lo = low[2 * i : 2 * i + 2]
        p = [term_at(10 + 2 * i), term_at(11 + 2 * i)]
        out += [
            f"HighTerm: {h[0]} # 500",
            f"MedTerm: {m[0]} # 50",
            f"LowTerm: {lo[0]} # 5",
            f'HighPhrase: "{p[0]} {p[1]}" # 50',
            f'MedPhrase: "{m[0]} {m[1]}" # 5',
            f'LowPhrase: "{lo[0]} {lo[1]}" # 1',
            f"AndHighHigh: +{h[0]} +{h[1]} # 50",
            f"AndHighMed: +{h[0]} +{m[0]} # 10",
            f"AndHighLow: +{h[0]} +{lo[0]} # 1",
            f"OrHighHigh: {h[0]} {h[1]} # 500",
            f"OrHighMed: {h[0]} {m[0]} # 500",
            f"OrHighLow: {h[0]} {lo[0]} # 500",
            f"Prefix3: t01{i}~",
            f"Wildcard: t02?{i}*",
            f"Fuzzy1: {term_at(12345 + 1111 * i)}~1",
            f"Fuzzy2: {term_at(16789 + 1111 * i)}~2",
            f"Or4High: {' '.join(h[:4])} # 500",
            f"Or6High4Med2Low: {' '.join(h + m + lo)} # 500",
            f"MinMatch2High2Med: 2 {h[0]} {h[1]} {m[0]} {m[1]} # 50",
            f"HighNGram: 7 {m[0]} {m[1]} {m[2]} # 50",
            f"MedNGram: 5 {' '.join(term_at(1000 + 4 * i + j) for j in range(4))} # 5",
            f"LowNGram: 5 {lo[0]} {lo[1]} {m[0]} # 1",
        ]
    return out


@contextlib.contextmanager
def planner_knobs(**knobs):
    """Set the port's planner knobs (``exec/plan.py:69-74``, and
    ``DSLICE_PAD`` of ``index/segment.py``, which only the planner reads
    after the pools are built) for the duration of the block. The plan
    cache key holds no knob, so the cache is cleared on entry and exit.
    The JAX package's knobs are its own: this touches none of them."""
    import iresearch_tpu_torch.index.segment as segmod
    from iresearch_tpu_torch.exec import plan as planmod
    from iresearch_tpu_torch.exec import plancache

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
