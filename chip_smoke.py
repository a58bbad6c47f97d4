#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

Drives the port's main path — ``QueryBatch(mix, [sr], BM25(), wand=True)
.prepare(0, 10).run_grouped()`` over the 400-query BM25 top-10 mix of
``bench.py`` on one 5M-doc segment — and checks it:

1. requires a CUDA device; prints the card's name and power limit;
2. builds the kernels (nvcc, first use) and prints the build time;
3. builds the 5M-doc segment (or loads it from ``.bench_cache/``);
4. uploads the segment state and prints its device bytes;
5. holds K1, K2 and K3 against their plain PyTorch versions on the card,
   on the real pools, starts and rows of the mix's plans (BM25 bit for
   bit; TFIDF and boost scoring on a small random grid to rtol 1e-6), and
   times each beside its plain version with CUDA events;
6. runs the main path once with every launch count reset before it, and
   fails unless each kernel launched; compares all 400 results with the
   plain-torch run of the same batch (docs exact, scores rtol 1e-5) and
   5 queries per category with the numpy oracle (``HostQuery``);
7. times synchronised batched passes (QPS, for the record);
8. on the same segment, drives the single-query executor
   (``DeviceQuery(..., device=dev)``) over ``bench.py``'s breadth
   categories but Phrase and PrefixHot, and one ``QueryBatch`` with a
   query per tier that decodes postings rows (fold, aux, wand, direct,
   sort, join, gridmix; planner knobs, where a tier needs them, set for
   that query's plan alone and printed). Each is run with the launch
   counts reset before it and fails unless K3 (every batch tier) or the
   category's kernels launched; each result passes the exactness gate
   against the plain-torch run and against ``HostQuery``; K3 is held bit
   for bit against its plain version on the rows that a fold group and a
   join group really gather, and timed; synchronised ms per query are
   printed for every category and tier.

It prints one JSON line of per-kernel results, then, as its last line,
``{"ok": true, "device": {...}}``. Any failure raises: the exit code is
not 0 and the last line is never printed. Usage: ``python3
chip_smoke.py`` (``--docs N`` runs a smaller corpus while debugging).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from collections import Counter

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
SOURCE = "iresearch_tpu_torch/kernels/csrc/irs_kernels.cu"
REPLACES = {
    "dense_scan_rowmax": "iresearch_tpu/ops/dense_scan.py:199",
    "dma_row_slices": "iresearch_tpu/ops/dma_gather.py:82",
    "decode_rows": "iresearch_tpu/ops/decode.py:100",
}
PER_CATEGORY_ORACLE = 5
PASSES = 20  # timed batched passes
SINGLE_REPS = 20  # timed runs per breadth category and tier (bench.py's 20)


def phase(name, t0):
    print(f"phase {name}: {time.perf_counter() - t0:.3f} s", flush=True)


def cuda_ms(torch, fn, iters=20, warmup=3):
    """Mean device time of ``fn`` in ms, between CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def max_abs_err(torch, got, want):
    """max |got - want| over entries finite in both; raises if the
    non-finite entries differ."""
    gf, wf = torch.isfinite(got), torch.isfinite(want)
    if not torch.equal(gf, wf) or not torch.equal(got[~gf], want[~wf]):
        raise AssertionError("non-finite entries differ")
    if not bool(gf.any()):
        return 0.0
    return float((got[gf].double() - want[wf].double()).abs().max())


def check_k1(torch, prep, out):
    """K1 vs plain on every scan group (BM25, bit for bit), timed."""
    from iresearch_tpu_torch.ops import dense_scan as ds

    calls = [c for c in prep.calls if c[0] == "scan"]
    if not calls:
        raise AssertionError("the mix has no fused-scan group")
    err = 0.0
    runs = []
    for _t, _q, _fn, args, kw in calls:
        pools, norms, starts, ws, avgdl_f, _avgdl_t = args
        kk = dict(scorer=kw["scorer"], span_bits=kw["span_bits"],
                  conj=kw["conj"], mm=kw["mm"])
        got = ds.dense_scan_rowmax(pools, starts, ws, norms, avgdl_f, **kk)
        want = ds.dense_scan_rowmax_ref(pools, starts, ws, norms, avgdl_f, **kk)
        torch.cuda.synchronize()
        if not torch.equal(got[0], want[0]):
            raise AssertionError(f"K1 row max differs: err {max_abs_err(torch, got[0], want[0])}")
        fin = torch.isfinite(want[0])
        if not torch.equal(got[1][fin], want[1][fin]):
            raise AssertionError("K1 argmax differs")
        err = max(err, max_abs_err(torch, got[0], want[0]))
        runs.append((pools, starts, ws, norms, avgdl_f, kk))
    shapes = [(tuple(r[1].shape), r[5]["span_bits"]) for r in runs]
    print(f"K1 bm25 vs plain: bit-exact on {len(runs)} scan groups {shapes}")
    ms = cuda_ms(torch, lambda: [ds.dense_scan_rowmax(p, s, w, n, a, **kk) for p, s, w, n, a, kk in runs])
    plain = cuda_ms(torch, lambda: [ds.dense_scan_rowmax_ref(p, s, w, n, a, **kk) for p, s, w, n, a, kk in runs], iters=5, warmup=1)
    out["dense_scan_rowmax"] = dict(max_abs_err=err, ms=ms, plain_ms=plain)
    check_k1_scorers(torch, norms.device)


def check_k1_scorers(torch, dev):
    """K1 vs plain with TFIDF, boost and non-default BM25 on a small random
    grid (rtol 1e-6: the kernel's rsqrtf may round differently)."""
    from iresearch_tpu.formats.bitpack import pack_blocks
    from iresearch_tpu.search.scorers import BM25, TFIDF, BoostScore
    from iresearch_tpu_torch.ops import dense_scan as ds

    rng = np.random.default_rng(7)
    ndrows, bits = 512, (8, 4, 16)
    pools = []
    for b in bits:
        f = rng.integers(0, 1 << min(b, 6), size=(2 * ndrows, 128)).astype(np.uint32)
        f[rng.integers(0, 2 * ndrows, size=ndrows // 2)] = 0
        pools.append(torch.from_numpy(pack_blocks(f, b).view(np.int32)).to(dev))
    norms = torch.from_numpy(rng.integers(1, 300, size=(ndrows, 128)).astype(np.uint16)).to(dev)
    starts = torch.from_numpy(rng.integers(0, ndrows, size=(3, 3)).astype(np.int32)).to(dev)
    ws = torch.from_numpy(rng.uniform(0.5, 3.0, size=(3, 3)).astype(np.float32)).to(dev)
    n = 0
    for scorer in (TFIDF(), TFIDF(with_norms=False), BoostScore(), BM25(k=0.9, b=0.4), BM25(b=0.0)):
        for conj, mm in ((False, 1), (True, 1), (False, 2)):
            kk = dict(scorer=scorer, span_bits=bits, conj=conj, mm=mm)
            got = ds.dense_scan_rowmax(pools, starts, ws, norms, 37.5, **kk)
            want = ds.dense_scan_rowmax_ref(pools, starts, ws, norms, 37.5, **kk)
            gf, wf = torch.isfinite(got[0]), torch.isfinite(want[0])
            if not torch.equal(gf, wf):
                raise AssertionError(f"K1 {scorer}: hit rows differ")
            torch.testing.assert_close(got[0][gf], want[0][wf], rtol=1e-6, atol=0.0)
            same = gf & (got[0] == want[0])
            if not torch.equal(got[1][same], want[1][same]):
                raise AssertionError(f"K1 {scorer}: argmax differs")
            n += 1
    print(f"K1 tfidf/boost/bm25 variants vs plain: {n} cases within rtol 1e-6")


def check_k2_k3(torch, prep, out):
    """K2 and K3 vs plain on every dslice group (bit for bit), timed."""
    from iresearch_tpu_torch.ops import decode as dc
    from iresearch_tpu_torch.ops import dma_gather as dg

    calls = [c for c in prep.calls if c[0] == "dslice"]
    if not calls:
        raise AssertionError("the mix has no dslice group")
    runs2, runs3 = [], []
    for _t, _q, _fn, args, kw in calls:
        pools, starts = args[0], args[1]
        R = kw["R"]
        bd, bf, _bn = kw["gbits"]
        got = dg.dma_row_slices(pools, starts, R)
        want = dg.dma_row_slices_ref(pools, starts, R)
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError("K2 differs from plain")
        runs2.append((pools, starts, R))
        m = starts.shape[0] * R
        rows = torch.arange(m, dtype=torch.int32, device=starts.device)
        a3 = (got[0].reshape(m, -1), got[1].reshape(m, -1), got[-1].reshape(m), rows, rows)
        d_got = dc.decode_rows(*a3, bd=bd, bf=bf)
        d_want = dc.decode_rows_ref(*a3, bd=bd, bf=bf)
        if not (torch.equal(d_got[0], d_want[0]) and torch.equal(d_got[1], d_want[1])):
            raise AssertionError("K3 differs from plain")
        runs3.append((a3, bd, bf))
    print(f"K2 vs plain: bit-exact on {len(runs2)} dslice groups "
          f"{[(tuple(r[1].shape), r[2], [tuple(p.shape) for p in r[0]]) for r in runs2]}")
    print(f"K3 vs plain: bit-exact on {len(runs3)} groups {[(r[0][3].shape[0], r[1], r[2]) for r in runs3]}")
    out["dma_row_slices"] = dict(
        max_abs_err=0.0,
        ms=cuda_ms(torch, lambda: [dg.dma_row_slices(*r) for r in runs2]),
        plain_ms=cuda_ms(torch, lambda: [dg.dma_row_slices_ref(*r) for r in runs2]),
    )
    out["decode_rows"] = dict(
        max_abs_err=0.0,
        ms=cuda_ms(torch, lambda: [dc.decode_rows(*a, bd=bd, bf=bf) for a, bd, bf in runs3]),
        plain_ms=cuda_ms(torch, lambda: [dc.decode_rows_ref(*a, bd=bd, bf=bf) for a, bd, bf in runs3]),
    )


def per_query(grouped, nq):
    vals = [None] * nq
    docs = [None] * nq
    for (v, d), qis in grouped:
        v, d = v.cpu().numpy(), d.cpu().numpy()
        for j, qi in enumerate(qis):
            vals[qi], docs[qi] = v[j], d[j]
    return vals, docs


def oracle_topk(flt, sr, scorer, k):
    """``HostQuery.top_k`` for one segment, ordered with numpy instead of
    a Python loop over every match."""
    from iresearch_tpu.search.host_eval import HostQuery

    r = HostQuery(flt, [sr], scorer).execute(0)
    docs = np.flatnonzero(r.match)
    sc = r.score[docs]
    o = np.lexsort((docs, -sc))[:k]
    return docs[o], sc[o]


def assert_gate(gv, gd, wd, wv, what):
    """The repo's exactness gate (as tests/topk_util.py applies it)
    on one top-k: (gv, gd) with -inf for non-matches against the matches
    (wd, wv) of a reference in (score desc, doc asc) order — same matches,
    scores to rtol 1e-5, doc order exact except for swaps inside
    near-ties."""
    fin = np.isfinite(gv)
    gd, gv = gd[fin], gv[fin]
    if len(gd) != len(wd):
        raise AssertionError(f"{what}: {len(gd)} vs {len(wd)} hits")
    np.testing.assert_allclose(gv, wv, rtol=1e-5, atol=1e-6, err_msg=what)
    want = dict(zip(wd.tolist(), wv.tolist()))
    for g, w, s in zip(gd.tolist(), wd.tolist(), wv.tolist()):
        if g != w and not (g in want and abs(want[g] - s) <= 1e-5 * abs(s) + 1e-6):
            raise AssertionError(f"{what}: doc {g} vs {w}")


def check_oracle(vals, docs, tasks, sr, scorer, k):
    """5 queries per category of the mix against the numpy oracle."""
    seen = Counter()
    n = 0
    for qi, (cat, flt) in enumerate(tasks):
        if seen[cat] >= PER_CATEGORY_ORACLE:
            continue
        seen[cat] += 1
        wd, wv = oracle_topk(flt, sr, scorer, k)
        assert_gate(vals[qi], docs[qi], wd, wv, f"oracle q{qi} {cat}")
        n += 1
    print(f"oracle (HostQuery, numpy): {n} queries {dict(seen)} pass the exactness gate")


def profile_passes(torch, prep, path, kind, smi, passes=5):
    """torch.profiler over ``passes`` synchronised batched passes: device
    time by kernel name (table to ``path``) and the device's busy share
    of the wall time."""
    from torch.profiler import ProfilerActivity, profile

    prep.run_grouped()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        for _ in range(passes):
            prep.run_grouped()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
    kernels = [e for e in prof.events() if e.device_type.name == "CUDA"]
    busy = sum(e.device_time_total for e in kernels) / 1e6  # us -> s
    by_name = Counter()
    for e in kernels:
        by_name[e.name] += e.device_time_total
    with open(path, "w") as f:
        f.write(f"{kind} ({smi}); {passes} passes\n")
        f.write(prof.key_averages().table(sort_by="device_time_total", row_limit=60))
    print(f"profile: {passes} passes, wall {wall / passes * 1e3:.4f} ms/pass, "
          f"device busy {busy / passes * 1e3:.4f} ms/pass "
          f"(idle share {1 - busy / wall:.4f}), {len(kernels) / passes:.1f} "
          f"device ops/pass; table in {path}")
    for name, us in by_name.most_common(8):
        print(f"  {us / passes / 1e3:.4f} ms/pass  {name[:100]}")
    from iresearch_tpu_torch.exec.batch import KERNELS

    per_tier = Counter()
    for tier, qis, fn, a, kw in prep.calls:
        t1 = time.perf_counter()
        ms = cuda_ms(torch, lambda: fn(KERNELS, *a, **kw), iters=10, warmup=2)
        wall_ms = (time.perf_counter() - t1) * 1e3 / 12
        per_tier[tier] += ms
        print(f"  group {tier:8s} Q={len(qis):3d}: {ms:.4f} ms between events "
              f"({wall_ms:.4f} ms wall per call incl. warm-up)")
    print(f"per tier, ms between events for the whole pass: {dict(per_tier)}")


def profile_tiers(torch, prep, smi, runs=3):
    """torch.profiler over ``runs`` synchronised runs of each tier group of
    phase 8: device ms per run and the three largest device operations."""
    from torch.profiler import ProfilerActivity, profile

    from iresearch_tpu_torch.exec.batch import KERNELS

    print(f"tier profile ({smi}), {runs} runs each:")
    for tier, _q, fn, args, kw in prep.calls:
        fn(KERNELS, *args, **kw)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            for _ in range(runs):
                fn(KERNELS, *args, **kw)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t1) / runs
        ops = [e for e in prof.events() if e.device_type.name == "CUDA"]
        by_name = Counter()
        for e in ops:
            by_name[e.name] += e.device_time_total
        busy = sum(by_name.values()) / runs / 1e3
        top = ", ".join(f"{us / runs / 1e3:.4f} ms {name[:60]}"
                        for name, us in by_name.most_common(3))
        print(f"  {tier:8s} wall {wall * 1e3:.4f} ms, device {busy:.4f} ms, "
              f"{len(ops) / runs:.0f} device ops: {top}")


def check_result(torch, got, plain, flt, sr, scorer, k, what):
    """One top-k (vals, docs tensors) through the exactness gate against
    the plain-torch run and against ``HostQuery``."""
    gv, gd = (t.cpu().numpy() for t in got)
    pv, pd = (t.cpu().numpy() for t in plain)
    fin = np.isfinite(pv)
    assert_gate(gv, gd, pd[fin], pv[fin], f"{what} vs plain")
    wd, wv = oracle_topk(flt, sr, scorer, k)
    assert_gate(gv, gd, wd, wv, f"{what} vs oracle")
    return int(fin.sum())


def expected_kernels(tier, plan):
    """The kernels a single query's tier must launch: K1 for the fused
    scan, K2 and K3 for dslice, K3 wherever postings rows are decoded;
    the skyline tier has no kernel (plain torch, as XLA on the TPU)."""
    if tier == "scan":
        return ("dense_scan_rowmax",)
    if tier == "dslice":
        return ("dma_row_slices", "decode_rows")
    if tier != "skyline" and plan.groups:
        return ("decode_rows",)
    return ()


def sync_ms(torch, fn, reps=SINGLE_REPS):
    """Host ms per call of ``fn`` over ``reps`` calls ending in a
    synchronise, after one warm call."""
    fn()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t1) * 1e3 / reps


def run_breadth(torch, sr, scorer, k, dev, smi):
    """Phase 8a: the single-query executor over bench.py's breadth
    categories. Phrase is left out because the single query's
    ``device_phrase=True`` default runs it on the device, which is not
    ported yet; PrefixHot because bench.py reports it apart."""
    from iresearch_tpu_torch import bench_mix
    from iresearch_tpu_torch.exec.executor import DeviceQuery
    from iresearch_tpu_torch.kernels import build as kb

    for name, flt, wand in bench_mix.breadth_tasks(sr):
        if name in ("Phrase", "PrefixHot"):
            continue
        dq = DeviceQuery(flt, [sr], scorer, wand=wand, device=dev)
        tier = dq.call(0, k)[0]
        kb.reset_launch_counts()
        got = dq.execute_segment_async(0, k)
        torch.cuda.synchronize()
        launches = {n: c for n, c in kb.launch_counts().items() if c}
        need = expected_kernels(tier, dq.plan_for_k(0, k))
        if not all(launches.get(n) for n in need):
            raise AssertionError(f"breadth {name} ({tier}): launches {launches}, needs {need}")
        hits = check_result(torch, got, dq.execute_segment_async(0, k, plain=True),
                            flt, sr, scorer, k, f"breadth {name}")
        ms = sync_ms(torch, lambda: dq.execute_segment_async(0, k))
        print(f"breadth {name:18s} tier {tier:8s} {hits:2d} hits, launches {launches}: "
              f"{ms:.4f} ms/query synchronised ({SINGLE_REPS} runs) on {smi}")


def run_tiers(torch, sr, scorer, k, dev, smi, kern):
    """Phase 8b: one QueryBatch with a query per row-decoding tier, each
    plan compiled under its own planner knobs; K3 must launch in every
    tier; K3 in gather form is held against its plain version on the rows
    that the fold and join groups decode."""
    from iresearch_tpu_torch import bench_mix
    from iresearch_tpu_torch.exec.batch import KERNELS, PLAIN, Kernels, QueryBatch
    from iresearch_tpu_torch.kernels import build as kb
    from iresearch_tpu_torch.ops import decode as dc

    tasks = bench_mix.tier_tasks(sr)
    qb = QueryBatch([f for _t, f, _k in tasks], [sr], scorer, wand=True, device=dev)
    for q, (tier, _f, knobs) in zip(qb.queries, tasks):
        if knobs:
            with bench_mix.planner_knobs(**knobs):
                q.plan(0)
            print(f"tier {tier}: planner knobs {knobs} set for this query's plan "
                  f"alone; plan cache cleared before and after")
    prep = qb.prepare(0, k)
    tiers = [c[0] for c in prep.calls]
    if tiers != [t for t, _f, _k in tasks]:
        raise AssertionError(f"batch groups {tiers}, expected one per tier")
    k3_total = 0
    for (tier, _q, fn, args, kw), (_t, flt, _k) in zip(prep.calls, tasks):
        kb.reset_launch_counts()
        got = fn(KERNELS, *args, **kw)
        torch.cuda.synchronize()
        launches = {n: c for n, c in kb.launch_counts().items() if c}
        if not launches.get("decode_rows"):
            raise AssertionError(f"tier {tier}: K3 never launched ({launches})")
        k3_total += launches["decode_rows"]
        plain = fn(PLAIN, *args, **kw)
        hits = check_result(torch, (got[0][0], got[1][0]), (plain[0][0], plain[1][0]),
                            flt, sr, scorer, k, f"tier {tier}")
        ms = sync_ms(torch, lambda: fn(KERNELS, *args, **kw))
        print(f"tier {tier:8s} {hits:2d} hits, launches {launches}: "
              f"{ms:.4f} ms/query synchronised ({SINGLE_REPS} runs) on {smi}")

    # K3 in gather form on the rows the fold and join groups really decode
    recorded = []

    def recording(*a, **kw):
        recorded.append((a, kw))
        return dc.decode_rows(*a, **kw)

    rec_kern = Kernels(KERNELS.rowmax, KERNELS.row_slices, recording)
    for tier, _q, fn, args, kw in prep.calls:
        if tier in ("fold", "join"):
            fn(rec_kern, *args, **kw)
    nrows = 0
    gathered = 0
    for a, kw in recorded:
        got = dc.decode_rows(*a, **kw)
        want = dc.decode_rows_ref(*a, **kw)
        torch.cuda.synchronize()
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            raise AssertionError(f"K3 gather form differs from plain on {a[3].shape[0]} rows")
        nrows += a[3].shape[0]
        gathered += int((a[3] != a[4]).sum())
    print(f"K3 gather form vs plain: bit-exact on {len(recorded)} calls of the fold and "
          f"join groups, {nrows} rows ({gathered} with rows_d != rows_f)")
    kern["decode_rows"].update(
        gather_rows=nrows,
        gather_ms=cuda_ms(torch, lambda: [dc.decode_rows(*a, **kw) for a, kw in recorded]),
        gather_plain_ms=cuda_ms(torch, lambda: [dc.decode_rows_ref(*a, **kw) for a, kw in recorded]),
        gather_launches=k3_total,
    )
    print(f"K3 gather form: {kern['decode_rows']['gather_ms']:.4f} ms vs plain "
          f"{kern['decode_rows']['gather_plain_ms']:.4f} ms for those {nrows} rows on {smi}")
    return prep


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--docs", type=int, default=5_000_000)
    ap.add_argument("--profile", metavar="FILE",
                    help="also profile 5 batched passes; kernel table to FILE")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    from iresearch_tpu.index.segment import SegmentReader
    from iresearch_tpu.search.scorers import BM25
    from iresearch_tpu_torch import bench_mix
    from iresearch_tpu_torch.device import require_cuda
    from iresearch_tpu_torch.exec.batch import QueryBatch
    from iresearch_tpu_torch.index.segment import device_state
    from iresearch_tpu_torch.kernels import build as kb

    t0 = time.perf_counter()
    dev = require_cuda()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind}")
    phase("1 device", t0)

    t0 = time.perf_counter()
    kb.library()
    print(f"nvcc build: {kb.build_seconds:.3f} s -> {kb.library_path().name}")
    print(kb.library_path().with_suffix(".log").read_text()[-3000:])
    phase("2 build", t0)

    t0 = time.perf_counter()
    data, cached = bench_mix.load_or_build(args.docs, os.path.join(REPO, ".bench_cache"))
    sr = SegmentReader("smoke", data)
    sr.dense_cache("body")
    print(f"segment: {sr.num_docs} docs, {'loaded' if cached else 'built'}")
    phase("3 segment", t0)

    t0 = time.perf_counter()
    st = device_state(sr, dev)
    dfield = st.field("body")
    cache = sr.dense_cache("body")
    for c, pool in enumerate(cache.pools):
        if len(pool) > 1:
            dfield.dense_words(cache, c)
    torch.cuda.synchronize()
    print(f"device state: {st.device_bytes} bytes "
          f"(allocated {torch.cuda.memory_allocated(dev)} bytes)")
    phase("4 upload", t0)

    scorer = BM25()
    k = bench_mix.K
    tasks = bench_mix.task_mix(sr)
    filters = [f for _c, f in tasks]

    t0 = time.perf_counter()
    prep = QueryBatch(filters, [sr], scorer, wand=True, device=dev).prepare(0, k)
    kern = {}
    check_k1(torch, prep, kern)
    check_k2_k3(torch, prep, kern)
    phase("5 kernels", t0)

    t0 = time.perf_counter()
    kb.reset_launch_counts()
    prep = QueryBatch(filters, [sr], scorer, wand=True, device=dev).prepare(0, k)
    grouped = prep.run_grouped()
    torch.cuda.synchronize()
    launches = kb.launch_counts()
    tiers = Counter(c[0] for c in prep.calls)
    tq = Counter()
    for t, qis, *_r in prep.calls:
        tq[t] += len(qis)
    print(f"groups per tier: {dict(tiers)}; queries per tier: {dict(tq)}")
    print(f"launches in the main-path run: {launches}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} never launched on the main path")
    if set(tiers) != {"skyline", "dslice", "scan"}:
        raise AssertionError(f"tiers {dict(tiers)}: expected all three")
    vals, docs = per_query(grouped, len(tasks))
    pvals, pdocs = per_query(prep.run_grouped(plain=True), len(tasks))
    for qi in range(len(tasks)):
        np.testing.assert_array_equal(docs[qi], pdocs[qi])
        np.testing.assert_allclose(vals[qi], pvals[qi], rtol=1e-5, atol=0.0)
    print(f"main path vs plain-torch run: {len(tasks)} queries match")
    check_oracle(vals, docs, tasks, sr, scorer, k)
    phase("6 main path", t0)

    t0 = time.perf_counter()
    prep.run_grouped()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(PASSES):
        prep.run_grouped()
    torch.cuda.synchronize()
    el = time.perf_counter() - t1
    qps = PASSES * len(tasks) / el
    print(f"batched passes: {PASSES} x {len(tasks)} queries in {el:.4f} s "
          f"-> {qps:.1f} QPS on {kind} ({smi})")
    phase("7 timing", t0)

    t0 = time.perf_counter()
    run_breadth(torch, sr, scorer, k, dev, smi)
    tier_prep = run_tiers(torch, sr, scorer, k, dev, smi, kern)
    phase("8 breadth and tiers", t0)
    if args.profile:
        profile_passes(torch, prep, args.profile, kind, smi)
        profile_tiers(torch, tier_prep, smi)

    # the port and this script import nothing of JAX, even where it is
    # installed (iresearch_tpu_torch/_host.py)
    jax_mods = sorted(m for m in sys.modules if m.split(".")[0] == "jax"
                      or m == "iresearch_tpu.exec.executor")
    if jax_mods:
        raise AssertionError(f"JAX modules imported: {jax_mods[:5]}")
    print("imports: no JAX module loaded")

    print(json.dumps({"kernels": [
        dict(name=name, route="cuda", source=SOURCE, replaces=REPLACES[name],
             launches=launches[name], **kern[name])
        for name in kb.KERNELS
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
