"""What the benchmark takes from the program (``iresearch_tpu_torch``).

The configuration's index is built through the program's own path: each
segment of the corpus is inverted by the port's ``invert_device`` on the
run's device and encoded by its ``encode_field_postings``, one field
``body`` with freqs and positions, term ``t`` spelled ``t`` and its id
in as many digits as the vocabulary's last id has (``t%07d`` past a
million terms). The segment's ``write_segment`` bytes
are kept under ``.bench_cache/benchmark/<config>/<seed>/`` of the
checkout, only the current seed's; a later run of the same seed opens
them with ``read_segment``, as a server opens its index.
"""

from __future__ import annotations

import os
import shutil
import time
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np
import torch

from benchmark.corpus import Corpus, Segment

FIELD = "body"


def digits(vocab: int) -> int:
    """Digits of a term's spelling: those of the vocabulary's last id, at
    least six."""
    return max(6, len(str(int(vocab) - 1)))


def term_text(term: int, vocab: int) -> str:
    return "t%0*d" % (digits(vocab), term)


def port_filter(q, vocab: int):
    """The program's filter of a benchmark query."""
    from iresearch_tpu_torch.search import filters as F

    leaves = [F.ByTerm(FIELD, term_text(t, vocab)) for t in q.terms]
    if q.op == "term":
        return leaves[0]
    return F.And(*leaves) if q.op == "and" else F.Or(*leaves)


def port_scorer(scorer: dict):
    """The program's scorer of a configuration's ``scorer`` entry."""
    from iresearch_tpu_torch.search.scorers import BM25

    if scorer["kind"] != "bm25":
        raise ValueError(f"scorer {scorer['kind']!r}")
    return BM25(k=float(scorer["k1"]), b=float(scorer["b"]))


def cache_sizes() -> Dict[str, int]:
    """Entries in the program's plan cache and in each LRU of fused passes."""
    from iresearch_tpu_torch.exec import batch, plancache

    out = {f"fused.{kind}": len(c) for kind, c in batch._FUSED_KINDS.items()}
    out["plans"] = plancache.plan_cache_info()[0]
    return out


def release() -> None:
    """Drop the program's cached plans and fused passes (their graphs and
    buffers), so that the reference finds the card's memory free."""
    from iresearch_tpu_torch.exec.batch import clear_fused_cache
    from iresearch_tpu_torch.exec.plancache import clear_plan_cache

    clear_plan_cache()
    clear_fused_cache()


def token_stream(seg: Segment) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(term ids i32, doc i32, position u32) of each token, on the host:
    what the port's inverter takes."""
    n, total = len(seg.lens), len(seg.tids)
    dev = seg.tids.device
    doc = torch.repeat_interleave(torch.arange(n, dtype=torch.int32, device=dev), seg.lens)
    pos = torch.arange(total, dtype=torch.int64, device=dev)
    pos -= torch.repeat_interleave(seg.starts, seg.lens)
    return (seg.tids.cpu().numpy(), doc.cpu().numpy(),
            pos.to(torch.int32).cpu().numpy().view(np.uint32))


def build_segment(seg: Segment, vocab: int, device, times: Dict[str, float]):
    """``SegmentData`` of one corpus segment, through the port."""
    from iresearch_tpu_torch.formats.postings import encode_field_postings
    from iresearch_tpu_torch.formats.spec import IndexFeatures
    from iresearch_tpu_torch.index.invert import invert_device
    from iresearch_tpu_torch.index.segment import SegmentData

    t = time.perf_counter()
    tids, doc, pos = token_stream(seg)
    inv = invert_device(tids, doc, pos, vocab, len(seg.lens), device=device)
    del tids, doc, pos
    times["invert_s"] = times.get("invert_s", 0.0) + time.perf_counter() - t
    t = time.perf_counter()
    present = np.flatnonzero(np.diff(inv.term_ptr) > 0)
    blob = b"".join(term_text(int(x), vocab).encode() for x in present)
    offs = np.arange(len(present) + 1, dtype=np.uint64) * np.uint64(1 + digits(vocab))
    tp = np.concatenate([inv.term_ptr[present], inv.term_ptr[-1:]])
    fp = encode_field_postings(
        inv.e_doc, inv.e_freq, tp, blob, offs, inv.norms, inv.pos_flat,
        IndexFeatures.FREQ | IndexFeatures.POS,
    )
    times["encode_s"] = times.get("encode_s", 0.0) + time.perf_counter() - t
    return SegmentData(len(seg.lens), {FIELD: fp}, {})


def open_index(cache: Path, corpus: Corpus, seed: int, device, log) -> Tuple[List, Dict[str, float]]:
    """The segment readers of the index of ``corpus`` (drawn for ``seed``)
    and the seconds each step of opening it took. ``cache`` is the
    configuration's directory: the segments' files lie in its
    ``<seed>/``, and no other seed's are kept."""
    from iresearch_tpu_torch.formats.segment_io import read_segment, write_segment
    from iresearch_tpu_torch.index.segment import SegmentReader

    times: Dict[str, float] = {}
    name = cache.name
    here = cache / str(int(seed))
    files = [here / f"seg{si}.bin" for si in range(len(corpus.segments))]
    readers = []
    if all(f.exists() for f in files):
        t = time.perf_counter()
        for si, f in enumerate(files):
            readers.append(SegmentReader(f"{name}-{si}", read_segment(f.read_bytes())))
        times["load_s"] = time.perf_counter() - t
        log(f"index: {len(files)} segment(s) of seed {seed} opened from {here}")
        return readers, times
    if cache.exists():
        shutil.rmtree(cache)
    here.mkdir(parents=True)
    for si, (seg, f) in enumerate(zip(corpus.segments, files)):
        data = build_segment(seg, corpus.vocab, device, times)
        t = time.perf_counter()
        tmp = f.with_suffix(".tmp")
        tmp.write_bytes(write_segment(data))
        os.replace(tmp, f)
        times["write_s"] = times.get("write_s", 0.0) + time.perf_counter() - t
        readers.append(SegmentReader(f"{name}-{si}", data))
    log(f"index: {len(files)} segment(s) of seed {seed} built into {here}")
    return readers, times
