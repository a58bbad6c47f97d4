"""BM25 top-10 query throughput of the port on one NVIDIA GPU: the
counterpart of the repo's ``bench.py``.

Builds (or loads from ``.bench_cache/``) the index over ``bench.py``'s
Zipf corpus, the reference's canonical 5M-doc run, in segments of
``BENCH_SEG_DOCS`` docs, and measures, as ``bench.py`` does:

* single-query latency: the mean over 100 runs ending in one sync, and
  p50/p95/p99 over 60 runs each synced on its own;
* ``bench.py``'s eight breadth categories, and PrefixHot from 1M docs up
  (20 runs each, 3 for PrefixHot);
* the 400-query batched pass through ``QueryBatch(mix, segments,
  wand=True)``, in blocks of passes, for at least 2 s;
* serving-shaped QPS over fresh filters, prepare included, for at least
  3 s;
* the cap counters of ``utils/metrics.registry()``.

A "sync" is the fetch of one scalar to the host; its round trip is
measured and logged. The single query and the batched pass run the port's
defaults: each replays a CUDA graph (``exec/batch.py``). Every run holds 25
queries of the batched pass (5 a category) against the numpy oracle
(``HostQuery``) under the exactness gate, and with more than one segment
and ``BENCH_VERIFY_MERGE`` set, the merged pass against the host merge
(``QueryBatch.search``).

Every number goes to stderr with the card's name and power limit beside
it. The last line of stdout is one JSON object: ``{"metric":
"bm25_top10_qps_single_chip", "value": QPS, "unit": "queries/sec",
"device", "power_limit_w", "failed", ...}``; ``failed`` names the breadth
categories that raised, and the process exits 1 after the line where it is
not empty. Without a card it fails at once and prints no line.

Run: ``python -m iresearch_tpu_torch.bench`` (env ``BENCH_DOCS``, default
5,000,000; ``BENCH_SEG_DOCS``, default 5,000,000; ``BENCH_VERIFY_MERGE``).
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np

K = 10
CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".bench_cache"
)


class Windows(NamedTuple):
    """How long each measurement runs (``bench.py``'s own by default)."""

    lat_runs: int = 100  # single queries ending in one sync
    pct_runs: int = 60  # single queries, each synced
    reps: int = 20  # runs per breadth category
    hot_reps: int = 3  # runs of PrefixHot
    calib_passes: int = 8  # batched passes that size a block
    batched_s: float = 2.0  # batched blocks run at least this long
    serve_s: float = 3.0  # serving cycles run at least this long


class Result(NamedTuple):
    """What ``run`` measured and computed: ``line`` is the last line's
    object; ``batched`` one batched pass's (vals [Q, k], global docs
    [Q, k]) as numpy, -inf for non-matches; ``single`` each breadth
    category's first single-query result (vals [k'], docs [k']);
    ``prepared`` the batch the timed passes ran (a ``PreparedBatch`` with
    one segment, a ``MergedBatch`` with more)."""

    line: dict
    tasks: List[Tuple[str, object]]
    batched: Tuple[np.ndarray, np.ndarray]
    single: Dict[str, Tuple[np.ndarray, np.ndarray]]
    prepared: object


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def card_label(dev) -> Tuple[str, Optional[float], str]:
    """(name, power limit W, the label every logged number carries)."""
    from iresearch_tpu_torch.device import describe

    name, watts = describe(dev)
    return name, watts, f"{name}, {'power limit not read' if watts is None else f'{watts:.2f} W'}"


def segment_sizes(num_docs: int, seg_docs: int) -> List[int]:
    """``bench.py``'s split: segments of ``seg_docs`` docs, the last one
    what is left."""
    return [min(seg_docs, num_docs - i * seg_docs) for i in range(-(-num_docs // seg_docs))]


def load_index(num_docs: int, seg_docs: int, cache_dir: Optional[str] = CACHE_DIR, log=log):
    """The index's segment readers: segment ``si`` (seed ``42 + si``)
    loaded from ``cache_dir`` under ``bench.py``'s file name or built and
    written there (``bench_mix.load_or_build``); logs the all-in memory
    ledger of ``bench.py:180-201``."""
    from iresearch_tpu_torch import bench_mix
    from iresearch_tpu_torch.index.segment import SegmentReader

    t0 = time.time()
    srs = []
    for si, n in enumerate(segment_sizes(num_docs, seg_docs)):
        data, cached = bench_mix.load_or_build(n, cache_dir, si)
        log(f"segment {si} ({n} docs) {'loaded from cache' if cached else 'built'} "
            f"({time.time() - t0:.1f}s)")
        srs.append(SegmentReader(f"bench{si}", data))
    pool = nrm = pos = dct = meta = ntokens = 0
    for sr in srs:
        f = sr.data.fields["body"]
        ntokens += f.total_term_freq
        pool += sum(a.nbytes for a in f.doc_words + f.freq_words)
        nrm += sum(a.nbytes for a in f.nrm_words) if f.nrm_words else 0
        pos += sum(a.nbytes for a in f.pos_words) if f.pos_words else 0
        dct += len(f.term_blob) + f.term_offsets.nbytes
        meta += sum(a.nbytes for a in f.base + f.bmax + f.bmaxf) + f.entries.nbytes + f.norms.nbytes
    total = pool + nrm + pos + dct + meta
    log(f"index built ({time.time() - t0:.1f}s): {len(srs)} segment(s), "
        f"postings {pool / 1e6:.1f}MB + inline norms {nrm / 1e6:.1f}MB "
        f"+ positions {pos / 1e6:.1f}MB + dict {dct / 1e6:.1f}MB + meta {meta / 1e6:.1f}MB "
        f"= {total / 1e6:.1f}MB all-in ({8 * total / max(1, ntokens):.2f} bits/token; "
        f"postings-only {8 * pool / max(1, ntokens):.2f})")
    return srs


def _sync(t) -> float:
    """Fetch one scalar of ``t`` to the host: the device finishes all it
    was given before it."""
    return float(t.reshape(-1)[0])


def _rows(grouped, nq: int, k: int):
    """One segment's grouped results as (vals [Q, k], docs [Q, k]) numpy,
    -inf and -1 past a group's k'."""
    vals = np.full((nq, k), -np.inf, np.float32)
    docs = np.full((nq, k), -1, np.int32)
    for (v, d), qis in grouped:
        v, d = v.cpu().numpy(), d.cpu().numpy()
        vals[qis, : v.shape[1]] = v
        docs[qis, : d.shape[1]] = d
    return vals, docs


def run(srs, *, device=None, windows: Windows = Windows(), verify_merge: bool = False,
        log=log) -> Result:
    """Measure the port over the segment readers ``srs`` on ``device`` (the
    card when None; raises without one). Logs every number with the card's
    label and returns a ``Result``. A breadth category that raises is
    logged and named in ``line["failed"]``; a result that fails the
    exactness gate raises."""
    from iresearch_tpu_torch import bench_mix
    from iresearch_tpu_torch.exec.batch import QueryBatch
    from iresearch_tpu_torch.exec.executor import DeviceQuery, entry_device
    from iresearch_tpu_torch.search import filters as F
    from iresearch_tpu_torch.search.scorers import BM25
    from iresearch_tpu_torch.utils.metrics import registry
    import torch

    dev = entry_device(device)
    name, watts, card = card_label(dev)
    scorer = BM25()
    nseg = len(srs)
    num_docs = sum(sr.num_docs for sr in srs)
    tasks = bench_mix.task_mix(srs[0])
    term_at = bench_mix._ranked(srs[0])[0]

    # the fixed cost of a sync, measured so that amortised numbers can
    # leave it out
    tiny = torch.ones(8, device=dev)
    _sync(tiny)
    rtts = []
    for _ in range(5):
        t2 = time.perf_counter()
        _sync(tiny * 1.0)
        rtts.append(time.perf_counter() - t2)
    rtt = sorted(rtts)[2]
    log(f"d2h round-trip: {rtt * 1000:.4f} ms (excluded where noted) on {card}")

    def prep_single(flt, wand=False):
        """A run() of the whole global query: the single-segment
        ``DeviceQuery``, or every segment's groups and the merge on the
        device (``prepare_all``)."""
        if nseg == 1:
            dq = DeviceQuery(flt, srs, scorer, wand=wand, device=dev)
            return lambda: dq.execute_segment_async(0, K)
        mb1 = QueryBatch([flt], srs, scorer, wand=wand, device=dev).prepare_all(K)
        return lambda: tuple(t[0] for t in mb1.run())

    run_single = prep_single(tasks[0][1])
    _sync(run_single()[0])
    t2 = time.perf_counter()
    for _ in range(windows.lat_runs):
        v, _d = run_single()
    _sync(v)
    lat = (time.perf_counter() - t2 - rtt) / windows.lat_runs
    log(f"single-query device time (completion-synced, amortized over "
        f"{windows.lat_runs}): {lat * 1000:.4f} ms (HighTerm) on {card}")

    samples = []
    for _ in range(windows.pct_runs):
        t2 = time.perf_counter()
        v, _d = run_single()
        _sync(v)
        samples.append(time.perf_counter() - t2)
    qs = np.quantile(np.array(samples), [0.5, 0.95, 0.99])
    log(f"single-query latency percentiles (per-query sync, HighTerm, {windows.pct_runs} "
        f"samples): p50 {qs[0] * 1000:.4f} / p95 {qs[1] * 1000:.4f} / p99 {qs[2] * 1000:.4f} ms "
        f"raw; rtt-subtracted p50 {(qs[0] - rtt) * 1000:.4f} / p99 {(qs[2] - rtt) * 1000:.4f} ms "
        f"on {card}")

    single, categories, failed = {}, {}, []
    for cat, flt, wand in bench_mix.breadth_tasks(srs[0], num_docs):
        reps = windows.hot_reps if cat == "PrefixHot" else windows.reps
        try:
            run_x = prep_single(flt, wand)
            first = run_x()
            single[cat] = tuple(t.cpu().numpy() for t in first)
            t2 = time.perf_counter()
            for _ in range(reps):
                v, _d = run_x()
            _sync(v)
        except Exception as e:  # a tail category must not stop the QPS phases
            log(f"{cat}: FAILED ({type(e).__name__}: {str(e)[:200]})")
            failed.append(cat)
            continue
        categories[cat] = (time.perf_counter() - t2 - rtt) / reps * 1000
        log(f"{cat}: {categories[cat]:.4f} ms/query (completion-synced) on {card}")

    qb = QueryBatch([f for _c, f in tasks], srs, scorer, wand=True, device=dev)
    tw = time.perf_counter()
    if nseg == 1:
        prep = qb.prepare(0, K)
        ngroups = len(prep.calls)

        def run_pass():
            return prep.run_grouped()[-1][0]

        grouped = prep.run_grouped()
        _sync(grouped[-1][0][0])
        batched = _rows(grouped, len(tasks), K)
    else:
        prep = qb.prepare_all(K)
        ngroups = len(prep.preps[0].calls)
        run_pass = prep.run
        res_v, res_d = run_pass()
        _sync(res_v)
        batched = (res_v.cpu().numpy(), res_d.cpu().numpy())
    log(f"warmup/compile done ({time.perf_counter() - tw:.1f}s, {nseg}x{ngroups} dispatch "
        f"groups) on {card}")

    seen = bench_mix.check_oracle(*batched, tasks, srs, scorer, K)
    log(f"oracle (HostQuery, numpy): {sum(seen.values())} queries {dict(seen)} of the batched "
        f"pass pass the exactness gate")
    if nseg > 1 and verify_merge:
        # the device merge against the host merge: the same docs in order,
        # scores to 1e-5
        ref = qb.search(K)
        got_v, got_d = batched
        for qi, ref_q in enumerate(ref):
            finite = np.isfinite(got_v[qi])
            if int(finite.sum()) != len(ref_q):
                raise AssertionError(f"merge q{qi}: {int(finite.sum())} vs {len(ref_q)} hits")
            for j, (rd, rv) in enumerate(ref_q):
                if int(got_d[qi, j]) != rd or abs(got_v[qi, j] - rv) > 1e-5 * max(1.0, abs(rv)):
                    raise AssertionError(f"merge q{qi} rank {j}: ({got_d[qi, j]}, "
                                         f"{got_v[qi, j]}) vs ({rd}, {rv})")
        log(f"device merge verified vs host merge over {len(ref)} queries")

    # blocks of passes end in one sync; a block is sized so that the sync
    # stays a small share of its time (bench.py:405-419)
    tc = time.perf_counter()
    for _ in range(windows.calib_passes):
        res_v, _res_d = run_pass()
    _sync(res_v)
    per_pass = max((time.perf_counter() - tc - rtt) / windows.calib_passes, 1e-4)
    block_passes = int(min(64, max(8, round(7 * rtt / per_pass))))
    log(f"calibration: {per_pass * 1000:.4f} ms/pass enqueue+compute, rtt {rtt * 1000:.4f} ms "
        f"-> BLOCK_PASSES={block_passes} on {card}")
    t1 = time.perf_counter()
    nq = 0
    while True:
        for _ in range(block_passes):
            res_v, _res_d = run_pass()
            nq += len(tasks)
        _sync(res_v)
        elapsed = time.perf_counter() - t1
        log(f"  {nq} queries complete at {elapsed:.4f}s on {card}")
        if elapsed >= windows.batched_s or nq >= 500 * len(tasks):
            break
    qps = nq / elapsed
    log(f"{nq} queries in {elapsed:.4f}s -> {qps:.1f} QPS (completion-synced) on {card}")

    def serve_batch(rot, do_sync=True):
        fresh = []
        for j in range(25):
            a = term_at(2 + (rot + j) % 600)
            b = term_at(200 + (rot + j) % 1200)
            fresh.append(F.ByTerm("body", a))
            fresh.append(F.And(F.ByTerm("body", a), F.ByTerm("body", b)))
        qb2 = QueryBatch(fresh, srs, scorer, wand=True, device=dev)
        if nseg == 1:
            last = qb2.prepare(0, K).run_grouped()[-1][0][0]
        else:
            last, _ld = qb2.prepare_all(K).run()
        if do_sync:
            _sync(last)
        return len(fresh), last

    # warm the rotations' graphs once (a steady server), then time fresh
    # filters over the same term shapes: prepare, plan, packed upload,
    # replay and completion inside the loop, one sync per cycle
    rots = [0, 37, 74, 111]
    for r in rots:
        serve_batch(r)
    t3 = time.perf_counter()
    nserve = 0
    while True:
        pend = 0
        for _ in range(4):
            for r in rots:
                n, last = serve_batch(r, do_sync=False)
                pend += n
        _sync(last)
        nserve += pend
        if time.perf_counter() - t3 >= windows.serve_s:
            break
    serve_el = time.perf_counter() - t3
    serve_qps = nserve / serve_el
    log(f"serving-shaped (new query strings end-to-end incl. prepare, warm graph cache): "
        f"{nserve} queries in {serve_el:.4f}s -> {serve_qps:.1f} QPS on {card}")

    for (cname, labels), v in sorted(registry()._counters.items()):
        log(f"cap counter {cname}{dict(labels) or ''}: {v:g}")

    line = {
        "metric": "bm25_top10_qps_single_chip", "value": qps, "unit": "queries/sec",
        "device": name, "power_limit_w": watts, "failed": failed,
        "docs": num_docs, "segments": nseg, "rtt_ms": rtt * 1000,
        "single_ms": lat * 1000,
        "single_p50_ms": qs[0] * 1000, "single_p95_ms": qs[1] * 1000,
        "single_p99_ms": qs[2] * 1000, "categories_ms": categories,
        "serving_qps": serve_qps,
    }
    return Result(line, tasks, batched, single, prep)


def main() -> int:
    from iresearch_tpu_torch.device import require_cuda

    try:
        dev = require_cuda()
    except RuntimeError as e:
        log(f"bench: {e}")
        return 1
    log(f"bench on {card_label(dev)[2]}")
    num_docs = int(os.environ.get("BENCH_DOCS", 5_000_000))
    seg_docs = int(os.environ.get("BENCH_SEG_DOCS", 5_000_000))
    srs = load_index(num_docs, seg_docs)
    res = run(srs, device=dev, verify_merge=bool(os.environ.get("BENCH_VERIFY_MERGE")))
    print(json.dumps(res.line), flush=True)
    return 1 if res.line["failed"] else 0


if __name__ == "__main__":
    # glibc heap reuse: every large numpy buffer of the index build would
    # otherwise be a fresh mmap, returned to the OS when freed and faulted
    # in again next time, where the kernel zeroes each new page. Keeping
    # every allocation on the brk heap (no mmap, no trim) pays first touch
    # once for the peak resident set instead of for all the allocation
    # traffic. Opt out with BENCH_NO_MALLOC_TUNE=1.
    if os.environ.get("MALLOC_MMAP_MAX_") is None and not os.environ.get("BENCH_NO_MALLOC_TUNE"):
        env = dict(os.environ, MALLOC_MMAP_MAX_="0", MALLOC_TRIM_THRESHOLD_="-1")
        os.execve(sys.executable, [sys.executable, "-m", "iresearch_tpu_torch.bench"] + sys.argv[1:], env)
    sys.exit(main())
