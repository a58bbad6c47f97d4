#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

Drives the port's main path — ``QueryBatch(mix, [sr], BM25(), wand=True)
.prepare(0, 10).run_grouped()`` over the 400-query BM25 top-10 mix of
``bench.py`` on one 5M-doc segment, one CUDA graph replayed per pass
(``exec/batch.py``'s fused pass) — and checks it:

1. requires a CUDA device; prints the card's name and power limit;
2. builds the kernels (nvcc, first use) and prints the build time;
3. builds the 5M-doc segment (or loads it from ``.bench_cache/``);
4. uploads the segment state and prints its device bytes;
5. holds K1, K2 and K3 (its plain form and its scored form,
   ``decode_score_rows``) against their plain PyTorch versions on the
   card, on the real pools, starts and rows of the mix's plans (BM25 bit
   for bit; TFIDF and boost scoring on a small random grid to rtol 1e-6),
   and times them. K1 is timed between CUDA events around eager calls
   (its device work outlasts the host's enqueue). K2, K3 and
   ``index_select`` take microseconds on the device and tens of
   microseconds to enqueue, so their ``ms`` is device time: the call list
   captured into one CUDA graph and replayed between events.
   ``enqueue_ms`` is the host's time for the same eager calls (no
   synchronise inside), ``launch_floor_ms`` the device time of one launch
   of an empty kernel under the same graph timing, ``bound_ms`` the
   larger of the bytes the call must move over 3.35 TB/s and its f32
   operations over 67 TFLOP/s, counted from this run's inputs, and
   ``target_ms`` the larger of ``bound_ms`` and the call list's launches
   times the floor. ``plain_ms`` is the plain version's eager time between
   events; ``library_ms``, for K2, one PyTorch call of the same function
   (``index_select`` per pool; the port never calls it). K4, the top-k
   select (``ops/topk.py:topk_docs``), on every call the mix's groups
   make: each against its plain version, the int64-key ``torch.topk``,
   bit for bit, and the call list timed as K2's (``library_ms``:
   ``torch.topk`` over the bare values, which has no tie rule);
6. runs the main path twice under PyTorch's sync debug mode set to raise:
   the first run captures the pass into a CUDA graph and replays it (its
   ms, the capture's host ms, the graph's nodes, its kernel launches per
   replay and the device bytes its cache entry holds are printed), the
   second, with every launch count reset before it, must hit the cache
   and only replay; fails unless each kernel launched; the result must
   equal the first run's, the eager pass's (``fused=False``) and the
   plain-torch run's bit for bit, and 5 queries per category pass the
   numpy oracle (``HostQuery``);
7. times synchronised batched passes, fused and eager in turns (ms and
   QPS, for the record; ``--profile``: device busy and idle share of each);
8. on the same segment, drives the single-query executor
   (``DeviceQuery(..., device=dev)``) over ``bench.py``'s breadth
   categories but Phrase (phase 9) and PrefixHot, and one ``QueryBatch`` with a
   query per tier that decodes postings rows (fold, aux, wand, direct,
   sort, join, gridmix; planner knobs, where a tier needs them, set for
   that query's plan alone and printed), whose fused pass (every tier in
   one graph, captured under the sync debug mode) must agree with its
   eager calls (docs equal, scores to rtol 1e-5: a fold's float
   scatter-adds sum in no fixed order on the card, so runs may differ in
   the last ulp; the bit-equal share is printed). Each is run with the launch
   counts reset before it and fails unless K3's scored form (every batch
   tier), K3's plain form (the join's probe) or the category's kernels
   launched; each result passes the exactness gate against the
   plain-torch run and against ``HostQuery``; K1 is held bit for bit
   against its plain version on every fused-scan category (four spans,
   min_match 2 among them), and both forms of K3 on the rows that a fold
   group and a join group really gather, and timed as in phase 5. Every
   single query runs fused (one CUDA graph per call signature,
   ``exec/batch.py:SingleCall``: its first run captured under the sync
   debug mode, as in phase 6, then a hit) and eager, the two held against
   each other; then one single query per tier
   (``bench_mix.single_tier_tasks``: skyline, scan, dslice, fold, aux,
   wand, direct, sort, join, gridmix) the same way, and for each a fresh
   ``DeviceQuery`` of another filter with the same signature (its terms
   moved by df rank, ``same_band``) must hit the first one's entry with
   no capture and give its own eager result; synchronised ms per query
   fused and eager, the miss and capture ms and the graph's nodes are
   printed for every category and tier;
9. phrases on the device, on the same segment: the single query's default
   (``device_phrase=True``, ``exec/phrase.py``) for ``bench.py``'s Phrase,
   a three-term phrase with a gap, and the phrase under And and Or with a
   term. Each plan must carry a ``device_aux`` row, and making its rows
   (once, before the fused call's first replay, which copies them into its
   entry) must launch K3's plain form once per phrase part; fused and
   eager as in phase 8, with a fresh phrase of the same signature that
   must hit; the result is held against the plain-torch run (docs
   equal, scores rtol 1e-5), against ``device_phrase=False`` (the host
   evaluation) and against ``HostQuery``; K3's plain form is held bit for
   bit against its plain version on the parts' rows and timed as in phase
   5 (``phrase_*`` keys); synchronised ms per query for both settings,
   and the ms of one evaluation of the phrase leaf on the device and on
   the host;
10. the index-wide path: a three-segment index of unequal sizes (the 5M-doc
   segment, a quarter of it with seed 43, and 1,000 docs with seed 44,
   ``bench.py``'s segment law, built here or loaded), all resident. The 400-query mix through
   ``QueryBatch(mix, segments).prepare_all(10).run()``: every segment's
   groups and the merge in one CUDA graph, captured and replayed as in
   phase 6 with no synchronise (PyTorch's sync debug mode raises on those
   it detects), then one fetch; K1, K2 and K3's scored form must launch;
   every call that the pass makes of a kernel's wrapper, in each segment
   (the smaller ones give the kernels other shapes), is held bit for bit
   against the plain version; the result is held against the eager pass
   and the plain-torch run as in phase 8, and against the host merge
   (``QueryBatch.search``) and 25 queries of the numpy oracle over all
   segments; device bytes per segment, ms and QPS of the fused and the
   eager pass as in phase 7, each segment's groups alone, the ms of the
   merge alone and synchronised ms for one query are printed. Then
   serving: 20 requests, each a fresh ``QueryBatch(mix, segments)
   .prepare_all(10).run()`` fetched, the fused cache emptied before the
   first; every request after the first must hit its entry with no
   capture, request 1's result agrees with request 20's and its tensors are
   unchanged after request 20; prepare and run ms per request and the
   end-to-end QPS are printed;
11. ``invert_device`` on the second segment's token stream against
   ``invert_numpy``, field by field, with the seconds of both;
12. the sharded executor over phase 10's index (``parallel/sharded.py``;
   one process holds all three segments): the 400-query mix through
   ``ShardedSearcher(segments, device=dev).prepare_many(mix, wand=True,
   k_max=10).run(10)``, every segment at the global ``nd_pad``, one CUDA
   graph per signature group. The first pass captures every group under
   the sync debug mode (per group its miss and capture ms, nodes,
   launches per replay and bytes), the second only replays, with no
   synchronise, and is fetched once; K3's scored form must launch and
   every wrapper call of the pass is held bit for bit against its plain
   version; the result is held against the eager pass and the plain-torch
   run (docs equal, scores rtol 1e-5), against phase 10's ``prepare_all``
   and 25 queries of the numpy oracle (the exactness gate). Two phrases
   (``bench.py``'s Phrase and three terms with a gap) must plan to
   ``PhraseKeysSpec`` rows and run in the keys form, against eager, plain
   and the oracle. Then ``SHARDED_REQUESTS`` fresh ``prepare_many``
   requests on an empty cache: every group of every request after the
   first must hit. Prints S, D, per_shard, nd_pad, the uniform dense
   layout's eligible terms, stride and device bytes, the tier and query
   count per group, the prepare seconds, ms and QPS of fused and eager
   passes in turns, the serving requests' prepare and run ms and
   synchronised ms for one query through ``prepare``;
13. ingest on the card: phase 10's second segment rebuilt as text (seed 43,
   1,250,000 docs; doc ``d`` is ``b"t%06d"`` of its token ids joined by
   spaces) goes in doc order, from one thread, through the port's
   ``IndexWriter`` with its default options (``"auto"`` inverts each
   flush on the card; ``segment_docs_max`` 2^20 gives flushes of
   1,048,576 and 201,424 docs) and the ``segmentation`` analyzer, into a
   ``MemoryDirectory``. ``commit()`` must publish two segments of those
   sizes; ``consolidate(consolidate_count())`` then one segment whose
   "body" field equals phase 10's segment array for array and whose file
   equals its bytes; a remove of the df-rank-2000 term masks its docs.
   The 400-query mix over the written index through
   ``QueryBatch(mix, reader.segments).prepare_all(10).run()``: captured and
   replayed as in phase 6 with no synchronise, K1, K2 and K3's scored form
   must launch, every wrapper call of the pass is held bit for bit against
   its plain version, the result against the eager pass (as in phase 8),
   the plain-torch run and 25 queries of the numpy oracle,
   and no deleted doc is returned. Prints docs/s and tokens/s of the
   inserts, each flush's seconds with its ``invert_device`` seconds, the
   flushes' peak device memory, commit, consolidate and reopen seconds,
   and the pass's QPS, device ops, idle share and launches;
14. the CLI and pyresearch on the card: the first 262,144 docs of phase
   13's text as a line-docs file, ``cli put --threads 4
   --segment-docs-max 131072 --consolidate --invert auto`` into an
   ``FSDirectory``, then ``cli search --topN 10 --max-tasks 5`` over a task
   file of the 22 categories (``bench_mix.task_lines``) with ``--engine
   device`` and ``--engine host``, all in-process through
   ``cli.__main__.main``. Each device task's hits pass the exactness gate
   against the host engine's, K1 and K3's scored form must launch, and
   every wrapper call of the device tasks, recorded again, is held bit for
   bit against the kernels' plain versions. ``cli dump`` runs as a
   subprocess, and ``pyresearch`` reads the index as the reader does.
   Prints docs/s of the put, each flush's ``invert_device`` seconds, the
   consolidate seconds, the device engine's fused-cache misses and hits
   (on an empty cache), per-category average µs of both engines and of
   the device tasks again eager and fused;
15. ``train_supervised`` on the card at AG News' shape (120,000 docs of
   the ``bench_mix`` corpus of seed 45, 4 labels, the module defaults:
   dim 16, 120 epochs, 2^15 buckets): the loss must fall and the training
   accuracy pass chance; the first 2,000 docs trained on the card and on
   the CPU (run in a thread beside the card's work) agree within the
   test's tolerance, with equal top-1 predictions wherever the CPU's
   margin exceeds it; the model saves and loads; a ``classification``
   field written on the card over 10,000 docs is found by a ``ByTerm`` on
   each label exactly for the docs ``predict`` gave it. Prints the
   seconds per step, the peak device memory and the loss;
16. ``dryrun_multihost(num_processes=2, devices_per_proc=4,
   device="cuda")``: two processes of one ``gloo`` group on one card (the
   first: eight cards would give each process four of its own), each
   holding 4 of the 8 segments of the JAX dryrun's 1,536 docs in 4
   shards; both must print ``MULTIHOST_OK`` (exact parity with the host
   oracle, no ``jax`` or ``iresearch_tpu`` module loaded), their launches
   and a captured graph per signature group on each of their shards
   (``MULTIHOST_FUSED``; the ``all_gather`` runs after the replays);
17. the mesh of devices over phase 10's index: the 400-query mix through
   ``ShardedSearcher(srs, devices=...)``, over every visible card (one
   shard each) where there are two or more, else four shards on cuda:0
   (the three segments, one shard without a segment); prints the cards
   and shards on a line of their own. The first pass captures every
   group on every shard as in phase 12 (per card the pool growth), the
   second only replays with no synchronise; K3's scored form must launch
   on every shard that holds a segment (its launches per shard printed),
   every wrapper call of every shard is held bit for bit against its
   plain version, and the result against the first and the eager pass,
   phase 12's one-shard result (docs equal, scores rtol 1e-5) and phase
   10's ``prepare_all``; the gather alone (copies onto the first card,
   concat, re-rank) between events; ``MESH_PASSES`` timed passes each
   way; then the JAX package's ``dryrun_multichip`` on the same devices
   (256 docs a segment, one segment a shard, written by the port's own
   writer; term, WAND Or, min-match, And, phrase and gridmix queries
   against the host oracle, fused against eager, every wrapper call
   against plain);
19. (run after 17, before 18) the NCCL mesh over phase 10's index: an
   NCCL group of one process opened here on cuda:0 and passed as
   ``group=`` to ``ShardedSearcher(srs, group=..., devices=[cuda:0] *
   4)``, one CUDA graph per signature group holding every shard's
   runners, the ``all_gather`` and the re-rank (``run_nccl``): the second
   pass replays with no synchronise and no call into
   ``torch.distributed``, launches what phase 17's pass launched (K3's
   scored form per group graph printed), every wrapper call held against
   plain, the result against the eager pass, phase 17's and phase 12's
   (docs equal, scores rtol 1e-5); the joins alone between events;
   ``MESH_PASSES`` timed passes each way; the group destroyed. Where two
   or more cards are visible, one process per card in an NCCL group over
   the segment files of phase 10 (``serve_multihost``), each printing its
   ms a pass fused and eager, its card's idle share and its result, which
   must equal the one-card result;
18. the port's benchmark entry points (``iresearch_tpu_torch/bench*.py``,
   the counterparts of the repo's ``bench.py``, ``bench_build.py`` and
   ``bench_micro.py``): ``bench.run`` over the 5M-doc segment with
   ``bench.py``'s windows (single-query mean over 100 runs and p50/p95/p99
   over 60, the breadth categories, the batched pass for 2 s, serving for
   3 s, 25 queries of the pass through the oracle gate),
   ``bench_build.run`` at 20,000 docs with 4 threads and
   ``bench_micro.run``. The bench's last-line object must carry its keys
   and an empty ``failed``; K1, K2 and both forms of K3 must launch in the
   three; every wrapper call of one batched pass of the bench is held
   against plain, and the micro table's decode row against K3's plain
   version; their numbers are printed.

The port and this script import nothing of ``jax`` or of the JAX package
``iresearch_tpu``; the run fails if either was loaded.

It prints one JSON line of per-kernel results (``launches`` counts, each
with the counts reset just before it: the replayed 400-query pass of
phase 6 (a graph replay counts the launches its capture recorded), the
tier batch of phase 8, one replay of each tier's single query, the rows
and one replay of phase 9's queries, the replayed index pass of phase
10, one replayed sharded pass of phase 12, the replayed pass over phase
13's written index, phase 14's device search, phase 16's workers,
phase 17's replayed mesh pass and dryrun, phase 19's replayed pass (and
its workers' on several cards) and phase 18's entry points),
then, as its last line, ``{"ok": true,
"device": {...}}``. Any failure raises: the exit code is not 0 and the
last line is never printed. Usage: ``python3 chip_smoke.py`` (``--docs
N`` runs a smaller corpus while debugging, ``--ingest-docs N`` a smaller
phase 13; ``--profile FILE`` adds a
torch.profiler breakdown with the kernels' in-pass device durations;
``--kernel-times`` stops after the kernels' checks and timings of phases
5 and 8, and also runs from a copy of this script in an older tree of
the port, whose kernels it then times the same way).
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import io
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
from collections import Counter

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
SOURCE = "iresearch_tpu_torch/kernels/csrc/irs_kernels.cu"
SOURCES = {"topk_docs": "iresearch_tpu_torch/kernels/csrc/irs_topk.cu"}
REPLACES = {
    "dense_scan_rowmax": "iresearch_tpu/ops/dense_scan.py:199",
    "dma_row_slices": "iresearch_tpu/ops/dma_gather.py:82",
    "decode_rows": "iresearch_tpu/ops/decode.py:100",
    "decode_score_rows": "iresearch_tpu/ops/decode.py:100",
    "topk_docs": "none (XLA's lax.top_k, iresearch_tpu/ops/topk.py:wide_top_k)",
}
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)
F32_OPS_PER_S = 67e12  # H100 SXM f32 outside the tensor cores
PER_CATEGORY_ORACLE = 5
PASSES = 20  # timed batched passes
# timed sharded passes each way, in each of both_ways' four turns (eager
# 2-4 s each: cut from 20 to 5 to make room for phases 14-16, to 3 when the
# fused passes and 5 serving requests joined phase 12, and to 1 when phase
# 19 joined: the whole script took 1,128 s of its 1,200 s on a slow host)
SHARDED_PASSES = 1
SHARDED_REQUESTS = 5  # fresh prepare_many requests served in phase 12
SINGLE_REPS = 20  # timed runs per breadth category and tier (bench.py's 20)
MESH_PASSES = 1  # timed mesh passes each way and turn (phases 17, 19; cut from 2 as above)
MESH_SHARDS_ONE_CARD = 4  # phase 17's shards where one card is visible
NCCL_SHARDS = 4  # phase 19's shards on cuda:0 in its group of one process
GRAPH_INNER = 10  # copies of a call list in one captured graph
GRAPH_REPLAYS = 20  # timed replays of that graph


@contextlib.contextmanager
def scoped_clock():
    """Install a timer registry that notes every scoped timer of the port
    (``utils/timer.py``) call by call: yields the list it appends
    (name, seconds, thread ident) to, in the order the calls end."""
    from iresearch_tpu_torch.utils import timer

    calls = []

    class Clock(timer.TimerRegistry):
        @contextlib.contextmanager
        def scoped(self, name):
            t = time.perf_counter()
            try:
                yield
            finally:
                calls.append((name, time.perf_counter() - t, threading.get_ident()))

    saved, timer._registry = timer._registry, Clock()
    try:
        yield calls
    finally:
        timer._registry = saved


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


def graph_ms(torch, fn):
    """Device ms per run of ``fn``: GRAPH_INNER runs captured into one CUDA
    graph (the kernels' foreign launches go to the capturing stream, their
    outputs come from the graph's pool), replayed GRAPH_REPLAYS times
    between CUDA events. No host work lies between the launches."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(GRAPH_INNER):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(GRAPH_REPLAYS):
        graph.replay()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / (GRAPH_REPLAYS * GRAPH_INNER)


def enqueue_ms(torch, fn, iters=200, warmup=3):
    """Host ms per run of ``fn`` to enqueue its work: no synchronise
    inside the timed loop, one after it."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(iters):
        fn()
    el = time.perf_counter() - t1
    torch.cuda.synchronize()
    return el * 1e3 / iters


def launch_floor(torch, dev):
    """Device ms of one launch of the library's empty kernel under
    ``graph_ms``; None where the library has none (an older tree)."""
    from iresearch_tpu_torch.kernels import build as kb

    if not hasattr(kb, "launch_noop"):
        return None
    return graph_ms(torch, lambda: kb.launch_noop(torch.cuda.current_stream(dev)))


def timed(torch, kernel, plain, n_launches, nbytes, flops, floor, library=None):
    """One kernel's timing keys for a call list (see the module note)."""
    bms, by = bound(nbytes, flops)
    return dict(
        ms=graph_ms(torch, kernel), enqueue_ms=enqueue_ms(torch, kernel),
        plain_ms=cuda_ms(torch, plain),
        library_ms=None if library is None else graph_ms(torch, library),
        bound_ms=bms, bound_by=by, launch_floor_ms=floor,
        target_ms=bms if floor is None else max(bms, n_launches * floor),
    )


def bound(nbytes, flops=0.0):
    """(bound_ms, bound_by): the larger of the bytes over the memory rate
    and the f32 operations over the f32 peak."""
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = flops / F32_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def record_calls(kernels, fn, args, kw):
    """Run ``fn`` on the kernel set with every kernel wrapped to note its
    arguments: {field: [(args, kwargs), ...]} of the calls it really made.
    A ``topk`` call (K4) is held against its plain version as it returns
    (``k4_noted``), so that its short-lived inputs are not kept, and noted
    by its (Q, n, k)."""
    rec = {name: [] for name in kernels._fields}

    def noting(name, kernel):
        def call(*a, **k):
            out = kernel(*a, **k)
            rec[name].append(k4_noted(a, out) if name == "topk" else (a, k))
            return out
        return call

    fn(kernels._replace(**{n: noting(n, getattr(kernels, n)) for n in kernels._fields}),
       *args, **kw)
    return rec


def recorded(calls):
    """``record_calls`` over the groups ``calls`` of a prepared batch, on
    the kernels: {field: every call the groups made, in order}."""
    from iresearch_tpu_torch.exec.batch import KERNELS

    rec = {name: [] for name in KERNELS._fields}
    for _t, _q, fn, args, kw in calls:
        for name, made in record_calls(KERNELS, fn, args, kw).items():
            rec[name].extend(made)
    return rec


def k3_lists(rec):
    """(plain, scored) K3 call lists of recorded calls: every decode as
    (5 arguments, widths), the scored form's among them, and the scored
    form's own calls."""
    scored = rec.get("decode_score", [])
    plain = [(a[:5], dict(bd=k["bd"], bf=k["bf"])) for a, k in scored] + rec["decode"]
    return plain, scored


def k1_work(torch, run):
    """(bytes, f32 ops) that K1 needs on one call's inputs: each distinct
    (span, start) row range, the norms, starts and weights read once and
    the [Q, ndrows] outputs written once; the score's 5 f32 operations
    (w * f, f + pre, max, divide, the sum) per hit lane and span with
    f != 0, and 2 per lane for c1 * dl + c0. The hits follow the plain
    version's rule, counted on the card in query chunks."""
    from iresearch_tpu_torch.formats.bitpack import unpack_torch

    pools, starts, ws, norms, _avgdl, kk = run
    q, S = starts.shape
    ndrows = norms.shape[0]
    st = starts.cpu().numpy()
    nbytes = norms.numel() * norms.element_size() + starts.numel() * 8 + q * ndrows * 8
    for s, b in enumerate(kk["span_bits"]):
        nbytes += len(np.unique(st[:, s])) * ndrows * 16 * b
    ar = torch.arange(ndrows, device=starts.device)
    pairs = 0
    for a in range(0, q, 8):
        fs = [unpack_torch(pools[s][starts[a:a + 8, s, None].long() + ar], b)
              for s, b in enumerate(kk["span_bits"])]
        if kk["conj"]:
            hit = torch.stack([f > 0 for f in fs]).all(0) if kk["mm"] <= 1 else torch.zeros_like(fs[0], dtype=torch.bool)
        elif kk["mm"] > 1:
            hit = torch.stack([f > 0 for f in fs]).sum(0) >= kk["mm"]
        else:
            hit = sum(f.float() for f in fs) > 0
        pairs += sum(int((hit & (f != 0)).sum()) for f in fs)
    return nbytes, 5.0 * pairs + 2.0 * ndrows * 128


def k3_work(a, bd, bf):
    """Bytes that K3 needs for one call: each distinct doc row (words and
    base) and freq row read once, the row ids, the docs and freqs written
    once (integer work only, none at an f32 rate)."""
    _dw, _fw, _base, rows_d, rows_f = a
    n = rows_d.shape[0]
    ud = len(np.unique(rows_d.cpu().numpy()))
    uf = len(np.unique(rows_f.cpu().numpy()))
    return ud * (16 * bd + 4) + uf * 16 * bf + 8 * n + n * 128 * 8


def k3_score_work(a, kw, docs):
    """(bytes, f32 ops) of the scored form for one call: K3's bytes with
    scores in the freqs' place, plus each distinct norm row (or each
    distinct ``norms`` entry the decoded docs reach) and the weights read
    once, the match flags (and dl on request) written once; 6 f32
    operations a lane for BM25's expression."""
    rows_n, norms = a[6], a[7]
    n = a[3].shape[0]
    nbytes = k3_work(a[:5], kw["bd"], kw["bf"]) + 4 * n + n * 128
    if kw["bn"] >= 0:
        nbytes += len(np.unique(rows_n.cpu().numpy())) * 16 * kw["bn"] + 4 * n
    else:
        nbytes += 4 * len(np.unique(np.clip(docs.cpu().numpy(), 0, norms.shape[0] - 1)))
    if kw.get("want_dl"):
        nbytes += n * 128 * 4
    return nbytes, 6.0 * n * 128


def max_abs_err(torch, got, want):
    """max |got - want| over entries finite in both; raises if the
    non-finite entries differ."""
    gf, wf = torch.isfinite(got), torch.isfinite(want)
    if not torch.equal(gf, wf) or not torch.equal(got[~gf], want[~wf]):
        raise AssertionError("non-finite entries differ")
    if not bool(gf.any()):
        return 0.0
    return float((got[gf].double() - want[wf].double()).abs().max())


def shapes(keys, most=12):
    """The list of ``keys`` (call shapes), or where it is long the
    ``most`` commonest with their counts."""
    keys = list(keys)
    if len(keys) <= most:
        return keys
    return f"{len(Counter(keys))} shapes, commonest {Counter(keys).most_common(most)}"


def check_k3(torch, plain, scored, what):
    """Both forms of K3 bit for bit against their plain versions on the
    recorded calls; returns the scored calls' (bytes, f32 ops)."""
    from iresearch_tpu_torch.ops import decode as dc

    for a, kw in plain:
        got = dc.decode_rows(*a, **kw)
        want = dc.decode_rows_ref(*a, **kw)
        torch.cuda.synchronize()
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            raise AssertionError(f"K3 differs from plain ({what}, {a[3].shape[0]} rows)")
    nbytes = flops = 0
    for a, kw in scored:
        got = dc.decode_score_rows(*a, **kw)
        want = dc.decode_score_rows_ref(*a, **kw)
        torch.cuda.synchronize()
        if len(got) != len(want) or not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"K3 scored form differs from plain ({what}): score err "
                                 f"{max_abs_err(torch, got[1], want[1])}")
        work = k3_score_work(a, kw, got[0])
        nbytes, flops = nbytes + work[0], flops + work[1]
    print(f"K3 vs plain ({what}): bit-exact on {len(plain)} calls "
          f"{shapes((a[3].shape[0], kw['bd'], kw['bf']) for a, kw in plain)}; scored form "
          f"(docs, scores, match flags, dl) bit-exact on {len(scored)} calls "
          f"{shapes((a[3].shape[0], kw['bd'], kw['bf'], kw['bn'], bool(kw.get('want_dl'))) for a, kw in scored)}")
    return nbytes, flops


def check_k3_scorers(torch, dev):
    """K3's scored form vs plain with TFIDF, boost and non-default BM25, on
    inline norms and on the norms gather, on small random pools: every
    output but the scores bit for bit, the scores to rtol 1e-6, and says
    how many cases had bit-identical scores too."""
    from iresearch_tpu_torch.formats.bitpack import pack_blocks
    from iresearch_tpu_torch.ops import decode as dc
    from iresearch_tpu_torch.search.scorers import BM25, TFIDF, BoostScore

    rng = np.random.default_rng(9)
    nrows, R, bd, bf, bn = 512, 3001, 8, 4, 8

    def pool(b, cap):
        x = rng.integers(0, 1 << min(b, cap), size=(nrows, 128)).astype(np.uint32)
        x[0] = 0
        return torch.from_numpy(pack_blocks(x, b).view(np.int32)).to(dev)

    def ids():
        return torch.from_numpy(rng.integers(0, nrows, R).astype(np.int32)).to(dev)

    base = torch.from_numpy(rng.integers(0, 1000, nrows).astype(np.int32)).to(dev)
    norms = torch.from_numpy(rng.integers(1, 300, 1000 + 128 * 256).astype(np.float32)).to(dev)
    w = torch.from_numpy(rng.uniform(0.5, 3.0, R).astype(np.float32)).to(dev)
    head = (pool(bd, 8), pool(bf, 4), base, ids(), ids())
    nrm, rows_n = pool(bn, 8), ids()
    cases = exact = 0
    for scorer in (TFIDF(), TFIDF(with_norms=False), BoostScore(), BM25(k=0.9, b=0.4), BM25(b=0.0)):
        for b in (bn, -1):
            a = head + ((nrm, rows_n, None) if b >= 0 else (None, rows_n, norms)) + (w, 37.5)
            kw = dict(bd=bd, bf=bf, bn=b, scorer=scorer, want_dl=True)
            got = dc.decode_score_rows(*a, **kw)
            want = dc.decode_score_rows_ref(*a, **kw)
            torch.cuda.synchronize()
            if not all(torch.equal(got[i], want[i]) for i in (0, 2, 3)):
                raise AssertionError(f"K3 scored form {scorer}, bn={b}: docs, flags or dl differ")
            torch.testing.assert_close(got[1], want[1], rtol=1e-6, atol=0.0)
            cases += 1
            exact += int(torch.equal(got[1], want[1]))
    print(f"K3 scored form, tfidf/boost/bm25 variants vs plain: {cases} cases within rtol "
          f"1e-6, {exact} of them with bit-identical scores")


def time_k3(torch, plain, scored, scored_work, floor):
    """(plain form's, scored form's) timing keys on the two call lists;
    the scored form's is None without scored calls (an older tree)."""
    from iresearch_tpu_torch.ops import decode as dc

    p = timed(
        torch, lambda: [dc.decode_rows(*a, **kw) for a, kw in plain],
        lambda: [dc.decode_rows_ref(*a, **kw) for a, kw in plain],
        len(plain), sum(k3_work(a, kw["bd"], kw["bf"]) for a, kw in plain), 0.0, floor,
    )
    if not scored:
        return p, None
    return p, timed(
        torch, lambda: [dc.decode_score_rows(*a, **kw) for a, kw in scored],
        lambda: [dc.decode_score_rows_ref(*a, **kw) for a, kw in scored],
        len(scored), *scored_work, floor,
    )


def show(name, r, smi):
    print(f"{name}: device {r['ms']:.5f} ms, enqueue {r['enqueue_ms']:.5f} ms, plain "
          f"{r['plain_ms']:.4f} ms, library {r['library_ms']}, bound {r['bound_ms']:.5f} ms "
          f"by {r['bound_by']}, launch floor {r['launch_floor_ms']}, target "
          f"{r['target_ms']:.5f} ms on {smi}")


def k1_equal(torch, a, kk):
    """K1 on one call's arguments bit for bit against its plain version
    (the argmax wherever a row has a hit); returns the max abs error."""
    from iresearch_tpu_torch.ops import dense_scan as ds

    got = ds.dense_scan_rowmax(*a, **kk)
    want = ds.dense_scan_rowmax_ref(*a, **kk)
    torch.cuda.synchronize()
    if not torch.equal(got[0], want[0]):
        raise AssertionError(f"K1 row max differs: err {max_abs_err(torch, got[0], want[0])}")
    fin = torch.isfinite(want[0])
    if not torch.equal(got[1][fin], want[1][fin]):
        raise AssertionError("K1 argmax differs")
    return max_abs_err(torch, got[0], want[0])


def k2_equal(torch, pools, starts, R):
    """K2 on one call's arguments bit for bit against its plain version."""
    from iresearch_tpu_torch.ops import dma_gather as dg

    got = dg.dma_row_slices(pools, starts, R)
    want = dg.dma_row_slices_ref(pools, starts, R)
    torch.cuda.synchronize()
    if len(got) != len(want) or not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise AssertionError("K2 differs from plain")


def k4_noted(args, got):
    """One ``topk`` call (K4) on ``args`` (scores, docs, k) that returned
    ``got``, held bit for bit against its plain version, the key path, on
    the same inputs; returns its (Q, n, k)."""
    import torch

    from iresearch_tpu_torch.ops import topk as tk

    scores, docs, k = args
    want = tk.topk_docs_ref(scores, docs, k)
    shape = (scores[..., 0].numel(), scores.shape[-1], k)
    if (got[0].shape != want[0].shape or got[1].dtype != want[1].dtype
            or not torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
            or not torch.equal(got[1], want[1])):
        raise AssertionError(f"K4 differs from the key path at (Q, n, k) {shape}")
    return shape


def k4_launches(noted, what) -> int:
    """The K4 launches that the noted ``topk`` calls ([(Q, n, k)], each
    held against the key path already) made."""
    from iresearch_tpu_torch.ops import topk as tk

    n = sum(tk.launches(c[1], c[2]) for c in noted if c[0])
    print(f"K4 vs the key path ({what}): bit-exact on {len(noted)} calls "
          f"{dict(Counter(noted))} (Q, n, k), {n} launches")
    return n


def check_k4(torch, prep, kern, floor, smi):
    """K4 on every ``topk`` call of the groups of ``prep`` (one eager run
    of each, its inputs kept): held against the key path, then the call
    list timed as K2's; ``bound_ms`` from the bytes the calls must read
    and write."""
    from iresearch_tpu_torch.exec.batch import KERNELS
    from iresearch_tpu_torch.ops import topk as tk

    calls = []

    def keep(scores, docs, k):
        calls.append((scores.clone(), None if docs is None else docs.clone(), k))
        return tk.topk_docs(scores, docs, k)

    for _t, _q, fn, args, kw in prep.calls:
        fn(KERNELS._replace(topk=keep), *args, **kw)
    launches = k4_launches([k4_noted(c, tk.topk_docs(*c)) for c in calls], "main path's groups")
    nbytes = sum(s.numel() * 4 + (0 if d is None else d.numel() * d.element_size())
                 + s[..., 0].numel() * k * 8 for s, d, k in calls)
    r = timed(torch, lambda: [tk.topk_docs(s, d, k) for s, d, k in calls],
              lambda: [tk.topk_docs_ref(s, d, k) for s, d, k in calls], launches, nbytes, 0.0,
              floor, library=lambda: [torch.topk(s, k, dim=-1) for s, _d, k in calls])
    kern["topk_docs"] = dict(r, calls=len(calls), launches_checked=launches)
    show(f"topk_docs, {len(calls)} calls", r, smi)


def check_calls(torch, prep, what):
    """Every call of a kernel's wrapper that the groups of a prepared batch
    make, recorded and held bit for bit against the kernel's plain version
    on the same inputs (no timing); returns the calls checked per kernel."""
    return check_recorded(torch, recorded(prep.calls), what)


def check_recorded(torch, rec, what):
    """Recorded wrapper calls ({field: [(args, kwargs), ...]}) held bit for
    bit against the kernels' plain versions; returns the calls checked per
    kernel."""
    for a, kk in rec["rowmax"]:
        k1_equal(torch, a, kk)
    for a, _kw in rec["row_slices"]:
        k2_equal(torch, *a)
    print(f"K1 and K2 vs plain ({what}): bit-exact on {len(rec['rowmax'])} scans "
          f"{[(tuple(a[1].shape), a[3].shape[0]) for a, _kk in rec['rowmax']]} "
          f"(starts, grid rows) and {len(rec['row_slices'])} row-slice calls "
          f"{[(tuple(a[1].shape), a[2]) for a, _kw in rec['row_slices']]} (starts, R)")
    check_k3(torch, *k3_lists(rec), what)
    return Counter(dense_scan_rowmax=len(rec["rowmax"]), dma_row_slices=len(rec["row_slices"]),
                   decode_rows=len(rec["decode"]), decode_score_rows=len(rec["decode_score"]),
                   topk_docs=k4_launches(rec["topk"], what))


def check_merge(mb, what):
    """The cross-segment merge of a ``MergedBatch`` over its segments'
    eager groups, on the recorded kernels: its K4 calls held against the
    key path; returns the launches checked."""
    from iresearch_tpu_torch.exec.batch import KERNELS

    outs = [g for p in mb.preps for g, _q in p.run_grouped(False)]
    rec = record_calls(KERNELS, lambda kern: mb.merge(outs, mb._k(), kern), (), {})
    return Counter(topk_docs=k4_launches(rec["topk"], f"{what}, merge"))


def check_sharded(torch, prep, k, what):
    """Every wrapper call of one eager pass of a prepared sharded batch at
    top-``k``, group by group (``_group_body`` on the recorded kernels:
    each shard's runners, then the join or the one shard's re-rank), held
    bit for bit against the kernels' plain versions; returns the calls
    checked per kernel (K4's launches)."""
    from iresearch_tpu_torch.exec.batch import KERNELS

    s = prep.searcher
    rec = {name: [] for name in KERNELS._fields}
    for gi, (qis, _mode, _wand, cap) in enumerate(prep.groups):
        kk = min(k, s.nd_pad, cap)
        body = lambda kern: prep._group_body(gi, kk, len(qis), kern)(None)  # noqa: E731
        for name, made in record_calls(KERNELS, body, (), {}).items():
            rec[name].extend(made)
    return check_recorded(torch, rec, what)


def check_k1(torch, prep, out, floor):
    """K1 vs plain on every scan group (BM25, bit for bit), timed between
    events around eager calls."""
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
        err = max(err, k1_equal(torch, (pools, starts, ws, norms, avgdl_f), kk))
        runs.append((pools, starts, ws, norms, avgdl_f, kk))
    shapes = [(tuple(r[1].shape), r[5]["span_bits"]) for r in runs]
    print(f"K1 bm25 vs plain: bit-exact on {len(runs)} scan groups {shapes}")
    def kernel():
        return [ds.dense_scan_rowmax(p, s, w, n, a, **kk) for p, s, w, n, a, kk in runs]

    ms = cuda_ms(torch, kernel)
    plain = cuda_ms(torch, lambda: [ds.dense_scan_rowmax_ref(p, s, w, n, a, **kk) for p, s, w, n, a, kk in runs], iters=5, warmup=1)
    work = [k1_work(torch, r) for r in runs]
    nbytes, flops = sum(w[0] for w in work), sum(w[1] for w in work)
    bms, by = bound(nbytes, flops)
    print(f"K1: {ms:.4f} ms for the {len(runs)} groups (plain {plain:.4f} ms); needs "
          f"{nbytes} bytes and {flops:.0f} f32 ops -> bound {bms:.4f} ms by {by}")
    out["dense_scan_rowmax"] = dict(
        max_abs_err=err, ms=ms, enqueue_ms=enqueue_ms(torch, kernel), plain_ms=plain,
        bound_ms=bms, bound_by=by, library_ms=None, launch_floor_ms=floor,
        target_ms=bms if floor is None else max(bms, len(runs) * floor))
    check_k1_scorers(torch, norms.device)


def check_k1_scorers(torch, dev):
    """K1 vs plain with TFIDF, boost and non-default BM25 on a small random
    grid (rtol 1e-6: the kernel's rsqrtf may round differently)."""
    from iresearch_tpu_torch.formats.bitpack import pack_blocks
    from iresearch_tpu_torch.search.scorers import BM25, TFIDF, BoostScore
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
        for conj, mm in ((False, 1), (True, 1), (False, 2), (False, 3)):
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


def check_k2_k3(torch, prep, out, floor, smi):
    """K2 and both forms of K3 vs plain on the calls that every dslice
    group really makes (bit for bit), timed."""
    from iresearch_tpu_torch.ops import dma_gather as dg

    calls = [c for c in prep.calls if c[0] == "dslice"]
    if not calls:
        raise AssertionError("the mix has no dslice group")
    rec = recorded(calls)
    runs2 = [a for a, _kw in rec["row_slices"]]
    for r in runs2:
        k2_equal(torch, *r)
    print(f"K2 vs plain: bit-exact on {len(runs2)} dslice groups "
          f"{[(tuple(r[1].shape), r[2], [tuple(p.shape) for p in r[0]]) for r in runs2]}")
    plain, scored = k3_lists(rec)
    scored_work = check_k3(torch, plain, scored, "dslice form")
    # K2's bytes: each distinct window read once, every window written once
    k2_bytes = 0
    lib_runs = []  # index_select's row ids, made outside the timed calls
    for pools, starts, R in runs2:
        st = starts.cpu().numpy()
        ar = torch.arange(R, device=starts.device)
        for i, pool in enumerate(pools):
            row_bytes = R * pool.shape[1] * 4
            k2_bytes += len(np.unique(st[:, i])) * row_bytes + st.shape[0] * row_bytes
            lib_runs.append((pool, (starts[:, i, None].long() + ar).reshape(-1)))
        k2_bytes += starts.numel() * 4
    k2_lib = [p.index_select(0, i) for p, i in lib_runs]
    k2_got = [o.reshape(-1, o.shape[-1]) for pools, starts, R in runs2
              for o in dg.dma_row_slices(pools, starts, R)]
    if not all(torch.equal(a, b) for a, b in zip(k2_lib, k2_got)):
        raise AssertionError("index_select differs from K2")

    def library():
        return [p.index_select(0, i) for p, i in lib_runs]

    out["dma_row_slices"] = dict(max_abs_err=0.0, **timed(
        torch, lambda: [dg.dma_row_slices(*r) for r in runs2],
        lambda: [dg.dma_row_slices_ref(*r) for r in runs2],
        len(runs2), k2_bytes, 0.0, floor, library=library,
    ), library_enqueue_ms=enqueue_ms(torch, library))
    p, sc = time_k3(torch, plain, scored, scored_work, floor)
    out["decode_rows"] = dict(max_abs_err=0.0, **p)
    if sc is not None:
        out["decode_score_rows"] = dict(max_abs_err=0.0, **sc)
        check_k3_scorers(torch, starts.device)
    for name in out:
        if name != "dense_scan_rowmax":
            show(name, out[name], smi)
    print(f"index_select per pool ({len(lib_runs)} calls): enqueue "
          f"{out['dma_row_slices']['library_enqueue_ms']:.5f} ms")


def per_query(grouped, nq):
    vals = [None] * nq
    docs = [None] * nq
    for (v, d), qis in grouped:
        v, d = v.cpu().numpy(), d.cpu().numpy()
        for j, qi in enumerate(qis):
            vals[qi], docs[qi] = v[j], d[j]
    return vals, docs


def oracle_topk(flt, sr, scorer, k):
    """``HostQuery.top_k`` for one segment (``bench_mix.oracle_topk``)."""
    from iresearch_tpu_torch import bench_mix

    return bench_mix.oracle_topk(flt, [sr], scorer, k)


def assert_gate(gv, gd, wd, wv, what):
    """The repo's exactness gate on one top-k (``bench_mix.assert_gate``)."""
    from iresearch_tpu_torch import bench_mix

    bench_mix.assert_gate(gv, gd, wd, wv, what)


def check_oracle(vals, docs, tasks, sr, scorer, k):
    """5 queries per category of the mix against the numpy oracle."""
    from iresearch_tpu_torch import bench_mix

    seen = bench_mix.check_oracle(vals, docs, tasks, [sr], scorer, k, PER_CATEGORY_ORACLE)
    print(f"oracle (HostQuery, numpy): {sum(seen.values())} queries {dict(seen)} pass the "
          f"exactness gate")


def profile_passes(torch, run, path, kind, smi, calls=(), passes=5):
    """torch.profiler over ``passes`` synchronised passes of ``run()``:
    device time by kernel name (table to ``path``) and the device's busy
    share of the wall time; then each group of ``calls`` between events.
    Returns per pass: wall ms, device busy ms, idle share, device ops."""
    from torch.profiler import ProfilerActivity, profile

    run()
    sync_all(torch)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        for _ in range(passes):
            run()
        sync_all(torch)
        wall = time.perf_counter() - t1
    kernels = [e for e in prof.events() if e.device_type.name == "CUDA"]
    busy = sum(e.device_time_total for e in kernels) / 1e6  # us -> s
    per_card = Counter()
    for e in kernels:
        per_card[e.device_index] += e.device_time_total / 1e6
    if len(per_card) > 1:  # several cards: the idle share of each
        print("profile per card: " + ", ".join(
            f"cuda:{c} busy {b / passes * 1e3:.4f} ms/pass (idle share {1 - b / wall:.4f})"
            for c, b in sorted(per_card.items())))
    wall_all = wall * max(1, len(per_card))  # the cards' time, busy or idle
    by_name = Counter()
    count = Counter()
    for e in kernels:
        by_name[e.name] += e.device_time_total
        count[e.name] += 1
    with open(path, "w") as f:
        f.write(f"{kind} ({smi}); {passes} passes\n")
        f.write(prof.key_averages().table(sort_by="device_time_total", row_limit=60))
    print(f"profile: {passes} passes, wall {wall / passes * 1e3:.4f} ms/pass, "
          f"device busy {busy / passes * 1e3:.4f} ms/pass "
          f"(idle share {1 - busy / wall_all:.4f}), {len(kernels) / passes:.1f} "
          f"device ops/pass; table in {path}")
    for name, us in by_name.most_common(8):
        print(f"  {us / passes / 1e3:.4f} ms/pass  {name[:100]}")
    # the port's own kernels inside the pass, their inputs not in L2 from
    # a launch just before (the timed repeats of phase 5 keep them there)
    for name in sorted(by_name):
        if any(k in name for k in ("k1_", "k2_", "k3_")):
            print(f"  in-pass {name[:60]}: {count[name] / passes:.1f} launches/pass, "
                  f"{by_name[name] / count[name] / 1e3:.5f} ms device per launch")
    from iresearch_tpu_torch.exec.batch import KERNELS

    stats = dict(wall_ms=wall / passes * 1e3, busy_ms=busy / passes * 1e3,
                 idle_share=1 - busy / wall_all, device_ops=len(kernels) / passes)
    if not calls:
        return stats
    per_tier = Counter()
    for tier, qis, fn, a, kw in calls:
        t1 = time.perf_counter()
        ms = cuda_ms(torch, lambda: fn(KERNELS, *a, **kw), iters=10, warmup=2)
        wall_ms = (time.perf_counter() - t1) * 1e3 / 12
        per_tier[tier] += ms
        print(f"  group {tier:8s} Q={len(qis):3d}: {ms:.4f} ms between events "
              f"({wall_ms:.4f} ms wall per call incl. warm-up)")
    print(f"per tier, ms between events for the whole pass: {dict(per_tier)}")
    return stats


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
        own = ", ".join(f"{name.split('(')[0][-24:]} {us / runs / 1e3:.5f} ms"
                        for name, us in sorted(by_name.items())
                        if any(k in name for k in ("k2_", "k3_")))
        print(f"  {tier:8s} wall {wall * 1e3:.4f} ms, device {busy:.4f} ms, "
              f"{len(ops) / runs:.0f} device ops: {top}; of it {own}")


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
    scan, K2 and K3's scored form for dslice, the scored form wherever
    postings rows are decoded, and K3's plain form too where a join probes
    a sparse span; the skyline tier has no kernel (plain torch, as XLA on
    the TPU)."""
    if tier == "scan":
        return ("dense_scan_rowmax",)
    if tier == "dslice":
        return ("dma_row_slices", "decode_score_rows")
    if tier == "join" and len(plan.groups) > 1:
        return ("decode_score_rows", "decode_rows")
    if tier != "skyline" and plan.groups:
        return ("decode_score_rows",)
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


def first_fused(torch, run, kind, key, what, smi):
    """The first run of a fused pass (``exec/batch.py``: warm-up, capture,
    one replay), with PyTorch's sync debug mode set to raise, then a
    second run (a cache hit: one replay) under the same mode with the
    launch counts reset just before. Returns (first result, second
    result, the cache entry, its stats): the ms of the first run to its
    end, the capture's host ms, graph nodes, launches per replay, and the
    device bytes that the entry holds (reserved after the run, the
    allocator's cache emptied before and after, less before)."""
    from iresearch_tpu_torch.exec import batch as B
    from iresearch_tpu_torch.kernels import build as kb

    cache = B._FUSED_KINDS[kind]
    if key in cache:
        raise AssertionError(f"{what}: the fused pass was captured before")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    r0, a0 = torch.cuda.memory_reserved(), torch.cuda.memory_allocated()
    t1 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        first = run()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t1) * 1e3
    torch.cuda.empty_cache()
    entry = cache[key]
    stats = dict(first_ms=first_ms, capture_ms=entry.capture_s * 1e3, nodes=entry.nodes,
                 launches_per_replay=dict(entry.launches),
                 reserved_bytes=torch.cuda.memory_reserved() - r0,
                 allocated_bytes=torch.cuda.memory_allocated() - a0)
    n = len(cache)
    kb.reset_launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        second = run()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    if len(cache) != n or cache[key] is not entry:
        raise AssertionError(f"{what}: the second run captured again")
    print(f"{what} fused: first run (warm-up, capture under the sync debug mode set to "
          f"raise, one replay) {first_ms:.4f} ms, of it capture {stats['capture_ms']:.4f} ms "
          f"host; {entry.nodes} graph nodes; kernel launches per replay {stats['launches_per_replay']}; "
          f"the entry holds {stats['reserved_bytes']} bytes reserved "
          f"({stats['allocated_bytes']} allocated) on {smi}")
    return first, second, entry, stats


def same_results(torch, got, want, what, exact=False):
    """Raise unless two lists of (vals, docs) tensor pairs agree: docs
    equal, scores bit for bit when ``exact``, else to rtol 1e-5 (a fold's
    float scatter-adds sum in no fixed order on the card,
    ``exec/executor.py``, so two runs may differ in the last ulp). Prints
    how many pairs are bit-equal."""
    if len(got) != len(want):
        raise AssertionError(f"{what}: {len(got)} vs {len(want)} results")
    bits = 0
    for (gv, gd), (wv, wd) in zip(got, want):
        if gv.dtype != wv.dtype or gv.shape != wv.shape or not torch.equal(gd, wd):
            raise AssertionError(f"{what}: docs differ")
        if torch.equal(gv.view(torch.int32), wv.view(torch.int32)):
            bits += 1
        elif exact:
            raise AssertionError(f"{what}: scores differ")
        else:
            torch.testing.assert_close(gv, wv, rtol=1e-5, atol=0.0, msg=what)
    print(f"{what}: docs equal, scores bit-equal in {bits} of {len(got)} result pairs"
          + ("" if bits == len(got) else ", the others within rtol 1e-5"))


def pass_ms(torch, fn, passes=PASSES):
    """Host ms per synchronised pass over a loop of ``passes`` runs of ``fn``
    ending in one synchronise, after one warm run."""
    fn()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(passes):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t1) * 1e3 / passes


def both_ways(torch, run, n_queries, what, smi, kind, passes=PASSES):
    """Pass ms and QPS of ``run(fused=True)`` and ``run(fused=False)``, in
    turns (fused, eager, eager, fused), over ``passes`` passes each."""
    ms = {True: [], False: []}
    for fused in (True, False, False, True):
        ms[fused].append(pass_ms(torch, lambda: run(fused=fused), passes))
    for fused, name in ((True, "fused (graph replays)"), (False, "eager (fused=False)")):
        print(f"{what} {name}: {passes} passes x {n_queries} queries, "
              f"{[round(x, 4) for x in ms[fused]]} ms/pass -> "
              f"{[round(n_queries / x * 1e3, 1) for x in ms[fused]]} QPS on {kind} ({smi})")
    return ms


_RANKS = {}  # per segment: body term -> df rank


def same_band(flt, sr, d, only=None):
    """``flt`` with its body terms of df rank r replaced by the terms of
    rank r + d: every term, or only the ``only``-th met in the filter's
    fields in order (a query of the same kind, whose plan may share its
    signature). None where a rank would fall below 0."""
    from iresearch_tpu_torch import bench_mix

    term_at = bench_mix._ranked(sr)[0]
    if sr.serial not in _RANKS:
        fp = sr.data.fields["body"]
        order = np.argsort(-fp.entries[:, 0].astype(np.int64))
        tv = sr.terms("body")
        _RANKS[sr.serial] = {tv[int(t)]: r for r, t in enumerate(order)}
    ranks = _RANKS[sr.serial]
    seen = [0]

    def shift(x):
        if dataclasses.is_dataclass(x) and not isinstance(x, type):
            changes = {}
            for f in dataclasses.fields(x):
                v = getattr(x, f.name)
                if f.name == "term" and isinstance(v, bytes) and v in ranks:
                    i, seen[0] = seen[0], seen[0] + 1
                    if only is None or i == only:
                        if ranks[v] + d < 0:
                            raise IndexError(v)
                        changes[f.name] = term_at(ranks[v] + d).encode()
                else:
                    nv = shift(v)
                    if nv is not v:
                        changes[f.name] = nv
            if not changes:
                return x
            # the filters' own constructors take other arguments than
            # their fields: a copy with the fields set
            out = copy.copy(x)
            for name, v in changes.items():
                object.__setattr__(out, name, v)
            return out
        if isinstance(x, tuple):
            out = tuple(shift(e) for e in x)
            return out if any(a is not b for a, b in zip(out, x)) else x
        return x

    try:
        return shift(flt)
    except IndexError:
        return None


def single_query(sr, flt, scorer, dev, wand=False, knobs=None, device_phrase=True):
    """A ``DeviceQuery`` on ``dev``, its plan compiled under ``knobs``."""
    from iresearch_tpu_torch import bench_mix
    from iresearch_tpu_torch.exec.executor import DeviceQuery

    dq = DeviceQuery(flt, [sr], scorer, wand=wand, device_phrase=device_phrase, device=dev)
    if knobs:
        with bench_mix.planner_knobs(**knobs):
            dq.plan(0)
    return dq


def single_both_ways(torch, dq, k, what, smi):
    """A single query's fused call (``exec/batch.py:SingleCall``): its first
    run through ``first_fused`` (a miss: warm-up, capture, replay), then a
    hit; both held against the eager run (``fused=False``). Where an
    earlier query of the same signature made the entry, both runs are hits
    (under the sync debug mode set to raise) and the stats that entry's.
    Returns (the second run's result, the launches of its one replay, the
    stats, ms a query fused and eager)."""
    from iresearch_tpu_torch.exec import batch as B
    from iresearch_tpu_torch.kernels import build as kb

    key = dq.single_call(0, k).fused_entry()[0]
    entry = B._FUSED_KINDS["single"].get(key)
    if entry is None:
        first, second, _entry, stats = first_fused(
            torch, lambda: dq.execute_segment_async(0, k), "single", key, what, smi)
    else:
        hits = entry.hits
        torch.cuda.set_sync_debug_mode("error")
        try:
            first = dq.execute_segment_async(0, k)
            kb.reset_launch_counts()
            second = dq.execute_segment_async(0, k)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        if entry.hits != hits + 2:
            raise AssertionError(f"{what}: not a hit of the entry an earlier query made")
        stats = dict(first_ms=float("nan"), capture_ms=entry.capture_s * 1e3, nodes=entry.nodes)
        print(f"{what} fused: a hit of the entry an earlier query of the same signature "
              f"made ({entry.nodes} graph nodes), twice")
    torch.cuda.synchronize()
    launches = {n: c for n, c in kb.launch_counts().items() if c}
    eager = dq.execute_segment_async(0, k, fused=False)
    same_results(torch, [first, second], [eager, eager], f"{what}: fused runs and eager")
    ms = {f: sync_ms(torch, lambda: dq.execute_segment_async(0, k, fused=f)) for f in (True, False)}
    return second, launches, stats, ms


FRESH_SHIFTS = 24  # df-rank shifts tried each way for a query of the same signature


def fresh_hit(torch, sr, flt, make, k, what):
    """A fresh ``DeviceQuery`` (``make(filter)``) of ``flt`` with its terms
    moved by df rank (``same_band``: all of them, or one) that has the
    fused key of ``flt``'s call and another eager result: its fused call
    must hit that entry (no capture) and give its own eager result.
    Returns the shift (d, which term)."""
    from iresearch_tpu_torch.exec import batch as B

    first = make(flt).single_call(0, k)
    key = first.fused_entry()[0]
    cache = B._FUSED_KINDS["single"]
    entry = cache[key]
    docs = first.fn(B.KERNELS, *first.args, **first.kwargs)[1][0]
    nterms = repr(flt).count("term=b'")
    shifts = [(d * sign, only) for d in range(1, FRESH_SHIFTS + 1) for sign in (1, -1)
              for only in [None] + list(range(nterms) if nterms > 1 else [])]
    for d in shifts:
        other = same_band(flt, sr, *d)
        if other is None or other == flt:
            continue
        dq = make(other)
        call = dq.single_call(0, k)
        if call.fused_entry()[0] != key:
            continue
        eager = dq.execute_segment_async(0, k, fused=False)
        if torch.equal(eager[1], docs):
            continue
        hits, n = entry.hits, len(cache)
        got = dq.execute_segment_async(0, k)
        if entry.hits != hits + 1 or len(cache) != n or cache.get(key) is not entry:
            raise AssertionError(f"{what}: a fresh query of the same signature did not hit")
        same_results(torch, [got], [eager],
                     f"{what}: fresh query (df ranks {d[0]:+d} of term {d[1]}), a hit, and its eager run")
        return d
    raise AssertionError(f"{what}: no query of the same signature within {FRESH_SHIFTS} df ranks")


def run_breadth(torch, sr, scorer, k, dev, smi):
    """Phase 8a: the single-query executor over bench.py's breadth
    categories, each call fused (a graph per call signature) and eager.
    Phrase has a phase of its own (9); PrefixHot is left out because
    bench.py reports it apart."""
    from iresearch_tpu_torch import bench_mix
    from iresearch_tpu_torch.ops import dense_scan as ds

    for name, flt, wand in bench_mix.breadth_tasks(sr):
        if name in ("Phrase", "PrefixHot"):
            continue
        dq = single_query(sr, flt, scorer, dev, wand)
        call = dq.single_call(0, k)
        tier, args, kw = call.tier, call.args, call.kwargs
        if tier == "scan":  # K1 on this query's spans, bit for bit
            pools, norms, starts, ws, avgdl_f, _avgdl_t = args
            kk = dict(scorer=kw["scorer"], span_bits=kw["span_bits"],
                      conj=kw["conj"], mm=kw["mm"])
            got = ds.dense_scan_rowmax(pools, starts, ws, norms, avgdl_f, **kk)
            want = ds.dense_scan_rowmax_ref(pools, starts, ws, norms, avgdl_f, **kk)
            if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
                raise AssertionError(f"breadth {name}: K1 differs from plain")
            print(f"breadth {name}: K1 bit-exact vs plain on S={len(pools)} spans "
                  f"{kk['span_bits']}, conj={kk['conj']}, mm={kk['mm']}")
        got, launches, stats, ms = single_both_ways(torch, dq, k, f"breadth {name}", smi)
        need = expected_kernels(tier, dq.plan_for_k(0, k))
        if not all(launches.get(n) for n in need):
            raise AssertionError(f"breadth {name} ({tier}): launches {launches}, needs {need}")
        hits = check_result(torch, got, dq.execute_segment_async(0, k, plain=True),
                            flt, sr, scorer, k, f"breadth {name}")
        print(f"breadth {name:18s} tier {tier:8s} {hits:2d} hits, launches per replay "
              f"{launches}: {ms[True]:.4f} ms/query fused, {ms[False]:.4f} eager, synchronised "
              f"({SINGLE_REPS} runs); miss {stats['first_ms']:.4f} ms (capture "
              f"{stats['capture_ms']:.4f}), {stats['nodes']} graph nodes on {smi}")


def run_single_tiers(torch, sr, scorer, k, dev, smi):
    """Phase 8c: one single query per tier (``bench_mix.single_tier_tasks``
    but the phrase, phase 9's), fused and eager, against plain and the
    oracle; then one fresh ``DeviceQuery`` per tier of another filter with
    the same signature must hit the first one's entry. Returns the
    launches of the hits' replays, summed."""
    from iresearch_tpu_torch import bench_mix

    total = Counter()
    for tier, (flt, wand, knobs, dp) in bench_mix.single_tier_tasks(sr).items():
        if tier == "phrase":
            continue
        make = lambda f: single_query(sr, f, scorer, dev, wand, knobs, dp)  # noqa: E731
        dq = make(flt)
        got_tier = dq.single_call(0, k).tier
        if got_tier != tier:
            raise AssertionError(f"single {tier}: the query took the {got_tier} tier")
        got, launches, stats, ms = single_both_ways(torch, dq, k, f"single {tier}", smi)
        need = expected_kernels(tier, dq.plan_for_k(0, k))
        if not all(launches.get(n) for n in need):
            raise AssertionError(f"single {tier}: launches {launches}, needs {need}")
        total.update(launches)
        hits = check_result(torch, got, dq.execute_segment_async(0, k, plain=True),
                            flt, sr, scorer, k, f"single {tier}")
        d = fresh_hit(torch, sr, flt, make, k, f"single {tier}")
        print(f"single {tier:8s} {hits:2d} hits, launches per replay {launches}: "
              f"{ms[True]:.4f} ms/query fused, {ms[False]:.4f} eager, synchronised "
              f"({SINGLE_REPS} runs); miss {stats['first_ms']:.4f} ms (capture "
              f"{stats['capture_ms']:.4f}), {stats['nodes']} graph nodes; a fresh query "
              f"(df ranks {d[0]:+d} of term {d[1]}) hit on {smi}")
    return total


def tier_batch(sr, scorer, k, dev):
    """(prepared batch, tasks): one QueryBatch with a query per
    row-decoding tier, each plan compiled under its own planner knobs."""
    from iresearch_tpu_torch import bench_mix
    from iresearch_tpu_torch.exec.batch import QueryBatch

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
    return prep, tasks


def run_tiers(torch, prep, tasks, sr, scorer, k, smi):
    """Phase 8b: every tier of the batch launches K3's scored form (the
    join its plain form too) and passes the exactness gate; returns the
    launches summed over the tier calls."""
    from iresearch_tpu_torch.exec.batch import KERNELS, PLAIN
    from iresearch_tpu_torch.kernels import build as kb

    total = Counter()
    for (tier, _q, fn, args, kw), (_t, flt, _k) in zip(prep.calls, tasks):
        kb.reset_launch_counts()
        got = fn(KERNELS, *args, **kw)
        torch.cuda.synchronize()
        launches = {n: c for n, c in kb.launch_counts().items() if c}
        need = ("decode_score_rows",) + (("decode_rows",) if tier == "join" else ())
        if not all(launches.get(n) for n in need):
            raise AssertionError(f"tier {tier}: launches {launches}, needs {need}")
        total.update(launches)
        plain = fn(PLAIN, *args, **kw)
        hits = check_result(torch, (got[0][0], got[1][0]), (plain[0][0], plain[1][0]),
                            flt, sr, scorer, k, f"tier {tier}")
        ms = sync_ms(torch, lambda: fn(KERNELS, *args, **kw))
        print(f"tier {tier:8s} {hits:2d} hits, launches {launches}: "
              f"{ms:.4f} ms/query synchronised ({SINGLE_REPS} runs) on {smi}")
    return total


def check_gather(torch, prep, kern, floor, smi):
    """Both forms of K3 in gather form, on the rows that the fold and join
    groups really decode: held against plain and timed (``gather_*`` keys
    beside the dslice form's)."""
    rec = recorded([c for c in prep.calls if c[0] in ("fold", "join")])
    plain, scored = k3_lists(rec)
    scored_work = check_k3(torch, plain, scored, "gather form, fold and join groups")
    gathered = sum(int((a[3] != a[4]).sum()) for a, _kw in plain)
    print(f"K3 gather form: {sum(a[3].shape[0] for a, _kw in plain)} rows "
          f"({gathered} with rows_d != rows_f)")
    for name, r, calls in zip(("decode_rows", "decode_score_rows"),
                              time_k3(torch, plain, scored, scored_work, floor),
                              (plain, scored)):
        if r is not None:
            r["rows"] = sum(a[3].shape[0] for a, _kw in calls)
            kern[name].update({f"gather_{key}": v for key, v in r.items()})
            show(f"{name}, gather form, {r['rows']} rows in {len(calls)} calls", r, smi)


def run_phrases(torch, sr, scorer, k, dev, smi, kern, floor):
    """Phase 9: phrases through the single query's default
    (``device_phrase=True``), fused and eager; returns the launches that
    made each phrase's rows and of one replay of its call."""
    from iresearch_tpu_torch import bench_mix
    from iresearch_tpu_torch.exec import phrase as ph
    from iresearch_tpu_torch.exec.batch import KERNELS
    from iresearch_tpu_torch.exec.executor import DeviceQuery
    from iresearch_tpu_torch.kernels import build as kb
    from iresearch_tpu_torch.search import filters as F
    from iresearch_tpu_torch.search.host_eval import HostQuery

    term_at, _high, _med, low = bench_mix._ranked(sr)
    phrase = bench_mix.breadth_tasks(sr)[0][1]
    tasks = [
        ("Phrase", phrase),
        ("Phrase3Gap", F.ByPhrase("body", [term_at(10), term_at(11), (1, term_at(12))])),
        ("AndPhraseTerm", F.And(phrase, F.ByTerm("body", term_at(40)))),
        ("OrPhraseTerm", F.Or(phrase, F.ByTerm("body", low[4]))),
    ]
    total = Counter()
    decodes = []  # K3 plain-form calls of the phrase parts, as they were made
    for name, flt in tasks:
        dq = DeviceQuery(flt, [sr], scorer, device=dev)
        plan = dq.plan(0)
        if not plan.device_aux:
            raise AssertionError(f"phrase {name}: the plan has no device_aux row")
        parts = sum(len(spec.parts) for _a, spec in plan.device_aux)
        tier = dq.single_call(0, k).tier
        # the fused call's entry: its phrase rows are made here, once,
        # before any replay (K3's plain form once per part), and kept
        kb.reset_launch_counts()
        call = dq.single_call(0, k)
        rows = call.fused_entry()[1][1]
        torch.cuda.synchronize()
        made = {n: c for n, c in kb.launch_counts().items() if c}
        if made.get("decode_rows", 0) != parts:
            raise AssertionError(
                f"phrase {name}: launches {made}, needs decode_rows x {parts}")
        # the eager run reads views of the same rows: the plan keeps one copy
        made_rows = next(x for x in call._dev_args if callable(x))(KERNELS)
        if any(t.untyped_storage().data_ptr() != rows.untyped_storage().data_ptr()
               for pair in made_rows for t in pair):
            raise AssertionError(f"phrase {name}: the plan keeps a second copy of its rows")
        got, replay, stats, ms_both = single_both_ways(torch, dq, k, f"phrase {name}", smi)
        launches = dict(Counter(made) + Counter(replay))
        total.update(launches)
        plain = dq.execute_segment_async(0, k, plain=True)
        for g, w in zip(got, plain):
            g, w = g.cpu().numpy(), w.cpu().numpy()
            if g.dtype.kind == "i":
                np.testing.assert_array_equal(g, w, err_msg=f"phrase {name} vs plain")
            else:
                np.testing.assert_allclose(g, w, rtol=1e-5, atol=0.0)
        hits = check_result(torch, got, plain, flt, sr, scorer, k, f"phrase {name}")
        dh = DeviceQuery(flt, [sr], scorer, device_phrase=False, device=dev)
        if dh.plan(0).device_aux:
            raise AssertionError("device_phrase=False left a device_aux row")
        check_result(torch, got, dh.execute_segment_async(0, k), flt, sr, scorer, k,
                     f"phrase {name} vs host evaluation")
        d = fresh_hit(torch, sr, flt, lambda f: DeviceQuery(f, [sr], scorer, device=dev), k,
                      f"phrase {name}")
        ms = ms_both[True]
        ms_host = sync_ms(torch, lambda: dh.execute_segment_async(0, k))
        # one evaluation of the leaf itself: on the device (decode, keys,
        # sort, membership, count, score), and by the host oracle
        spec = plan.device_aux[0][1]
        rec = record_calls(
            KERNELS, lambda kn: ph.run_phrase_dense(
                spec, sr, scorer, plan.nd_pad, device=dev, kern=kn), (), {})
        decodes += rec["decode"]
        leaf_ms = sync_ms(torch, lambda: ph.run_phrase_dense(
            spec, sr, scorer, plan.nd_pad, device=dev))
        leaf = phrase if name != "Phrase3Gap" else flt
        t1 = time.perf_counter()
        pairs = HostQuery(leaf, [sr], scorer).eval_pairs(leaf, 0)
        host_ms = (time.perf_counter() - t1) * 1e3
        print(f"phrase {name:14s} tier {tier:5s} {hits:2d} hits, {parts} parts "
              f"(rows {[len(p.rows_d) for p in spec.parts]}, pos rows "
              f"{[len(p.rows_p) for p in spec.parts]}), launches of the rows {made} and of "
              f"a replay {replay}: {ms:.4f} ms/query fused on the device rows "
              f"({ms_both[False]:.4f} eager), {ms_host:.4f} ms/query on the host-evaluated "
              f"rows, eager (both rows kept with the plan; {SINGLE_REPS} runs); miss "
              f"{stats['first_ms']:.4f} ms (capture {stats['capture_ms']:.4f}), "
              f"{stats['nodes']} graph nodes; rows kept once by the plan, {rows.nbytes} bytes "
              f"({len(plan.device_aux)} leaves x {plan.nd_pad} lanes x 5 B), and once by "
              f"the entry; a fresh phrase (df ranks {d[0]:+d} of term "
              f"{d[1]}) hit; one "
              f"evaluation of the leaf: {leaf_ms:.4f} ms on the device, {host_ms:.1f} ms "
              f"on the host ({len(pairs.docs)} matching docs) on {smi}")
    # K3's plain form on the parts' rows: against plain, and timed
    check_k3(torch, decodes, [], "phrase parts")
    r, _none = time_k3(torch, decodes, [], None, floor)
    r["rows"] = sum(a[3].shape[0] for a, _kw in decodes)
    kern["decode_rows"].update({f"phrase_{key}": v for key, v in r.items()})
    show(f"decode_rows, phrase parts, {r['rows']} rows in {len(decodes)} calls", r, smi)
    return total


_ORACLE = {}  # phases 10 and 12 hold the same queries against the oracle


def oracle_topk_index(flt, srs, scorer, k):
    """``bench_mix.oracle_topk`` over every segment, kept per query."""
    from iresearch_tpu_torch import bench_mix

    key = (flt, tuple(sr.serial for sr in srs), scorer, k)
    if key not in _ORACLE:
        _ORACLE[key] = bench_mix.oracle_topk(flt, srs, scorer, k)
    return _ORACLE[key]


def run_index(torch, srs, tasks, scorer, k, dev, smi, kind, profile):
    """Phase 10: the 400-query mix over the multi-segment index through
    ``prepare_all(k).run()``; returns the launches of the checked pass and
    its (vals, docs)."""
    from iresearch_tpu_torch.exec.batch import QueryBatch
    from iresearch_tpu_torch.index.segment import device_state
    from iresearch_tpu_torch.kernels import build as kb

    filters = [f for _c, f in tasks]
    qb = QueryBatch(filters, srs, scorer, wand=True, device=dev)
    mb = qb.prepare_all(k)
    torch.cuda.synchronize()
    sizes = [sr.num_docs for sr in srs]
    nbytes = [device_state(sr, dev).device_bytes for sr in srs]
    print(f"index: {len(srs)} segments of {sizes} docs ({sum(sizes)} in all), device "
          f"bytes {nbytes} ({sum(nbytes)} in all; allocated "
          f"{torch.cuda.memory_allocated(dev)} bytes) on {smi}")
    for s, p in enumerate(mb.preps):
        tq = Counter()
        for t, qis, *_r in p.calls:
            tq[t] += len(qis)
        print(f"  segment {s}: groups per tier {dict(Counter(c[0] for c in p.calls))}, "
              f"queries per tier {dict(tq)}")
    # nothing in the pass may wait for the device, its capture included: a
    # synchronise raises here
    first, (vals_t, docs_t), entry, _stats = first_fused(torch, mb.run, "batch", mb.fused_key(),
                                                         "index pass", smi)
    # one fetch (and with it the one synchronise) ends the pass
    packed = torch.stack([vals_t.view(torch.int32), docs_t]).cpu().numpy()
    launches = kb.launch_counts()
    vals, docs = packed[0].view(np.float32), packed[1]
    print(f"index pass: enqueued with no synchronise, one fetch of {packed.nbytes} bytes; "
          f"launches {launches}")
    same_results(torch, [first], [(vals_t, docs_t)], "index pass: first and second fused run")
    for name in ("dense_scan_rowmax", "dma_row_slices", "decode_score_rows"):
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} never launched in the index pass")
    if vals.shape != (len(tasks), k) or not np.isfinite(vals[:, 0]).all():
        raise AssertionError(f"index pass: shape {vals.shape} or a query without a hit")
    # every wrapper call of the pass, segment by segment, against plain: the
    # smaller segments give the kernels shapes that segment 0 does not
    checked = [check_calls(torch, p, f"index segment {s}") for s, p in enumerate(mb.preps)]
    beyond = sum(checked[1:], Counter())
    checked.append(check_merge(mb, "index pass"))
    print(f"index pass, wrapper calls held against plain: {[dict(c) for c in checked]}")
    for name in ("dense_scan_rowmax", "dma_row_slices", "decode_score_rows"):
        if beyond[name] <= 0:
            raise AssertionError(f"kernel {name} was not checked beyond segment 0")
    for name, n in launches.items():
        if n > sum(c[name] for c in checked):
            raise AssertionError(f"kernel {name}: {n} launches in the pass, fewer calls checked")
    same_results(torch, [(vals_t, docs_t)], [mb.run(fused=False)], "index pass: fused and eager")
    plain = mb.run(plain=True)
    same_results(torch, [(vals_t, docs_t)], [plain], "index pass: fused and plain")
    pv, pd = (t.cpu().numpy() for t in plain)
    np.testing.assert_array_equal(docs, pd)
    np.testing.assert_allclose(vals, pv, rtol=1e-5, atol=0.0)
    print(f"index pass: the fused pass agrees with the eager pass and the plain-torch run "
          f"on all {len(tasks)} queries")
    ref = qb.search(k)
    for qi, r in enumerate(ref):
        fin = np.isfinite(vals[qi])
        np.testing.assert_array_equal(docs[qi][fin], [d for d, _v in r], err_msg=f"q{qi}")
        np.testing.assert_allclose(vals[qi][fin], [v for _d, v in r], rtol=1e-5, atol=0.0)
    print(f"index pass vs the host merge (QueryBatch.search): {len(ref)} queries match, "
          f"ties in (score desc, global doc asc) order")
    seen = Counter()
    for qi, (cat, flt) in enumerate(tasks):
        if seen[cat] < PER_CATEGORY_ORACLE:
            seen[cat] += 1
            wd, wv = oracle_topk_index(flt, srs, scorer, k)
            assert_gate(vals[qi], docs[qi], wd, wv, f"index oracle q{qi} {cat}")
    other = sum(int((docs[qi][np.isfinite(vals[qi])] >= sizes[0]).sum())
                for qi in range(len(tasks)))
    print(f"index oracle (HostQuery over all segments): {sum(seen.values())} queries "
          f"{dict(seen)} pass the exactness gate; {other} of the "
          f"{int(np.isfinite(vals).sum())} results lie outside segment 0")

    both_ways(torch, mb.run, len(tasks), "index passes", smi, kind)
    per_seg = {fused: [pass_ms(torch, lambda: p.run_grouped(fused)) for p in mb.preps]
               for fused in (True, False)}
    outs = [g for p in mb.preps for g, _q in p.run_grouped()]
    merge = lambda: mb.merge(outs)  # noqa: E731
    print(f"index: each segment's groups alone {[round(x, 4) for x in per_seg[True]]} ms/pass "
          f"fused, {[round(x, 4) for x in per_seg[False]]} eager; the merge alone "
          f"{cuda_ms(torch, merge):.4f} ms between events, "
          f"{enqueue_ms(torch, merge):.4f} ms to enqueue, on {kind} ({smi})")
    high0 = tasks[0][1]
    one = QueryBatch([high0], srs, scorer, device=dev).prepare_all(k)
    print(f"index single query (prepare_all, {len(srs)} segments + merge, fused): "
          f"{sync_ms(torch, one.run):.4f} ms/query synchronised ({SINGLE_REPS} runs); eager "
          f"{sync_ms(torch, lambda: one.run(fused=False)):.4f} on {smi}")
    if profile:
        for fused in (True, False):
            profile_passes(torch, lambda: mb.run(fused=fused),
                           f"{profile}.index.{'fused' if fused else 'eager'}", kind, smi)
    return launches, (vals, docs)


SERVE_REQUESTS = 20


def run_serving(torch, srs, tasks, scorer, k, dev, smi, kind):
    """Phase 10, serving: a fresh ``QueryBatch(mix, segments)
    .prepare_all(k).run()`` for each of ``SERVE_REQUESTS`` requests of the
    400-query mix, each fetched, with the fused cache emptied before the
    first. Every request after the first must hit the first one's entry (no
    capture: the entry and the cache's size unchanged); request 1's result
    equals the last one's, and request 1's device tensors, fetched again
    after the last request, are unchanged. Prints prepare and run ms per
    request and the end-to-end QPS."""
    from iresearch_tpu_torch.exec import batch as B
    from iresearch_tpu_torch.exec.batch import QueryBatch

    filters = [f for _c, f in tasks]
    B.clear_fused_cache()
    torch.cuda.synchronize()
    prep_ms, run_ms, fetched, kept = [], [], [], None
    key = entry = size = None
    t_all = time.perf_counter()
    for r in range(SERVE_REQUESTS):
        t1 = time.perf_counter()
        mb = QueryBatch(filters, srs, scorer, wand=True, device=dev).prepare_all(k)
        t2 = time.perf_counter()
        vals, docs = mb.run()
        fetched.append(torch.stack([vals.view(torch.int32), docs]).cpu().numpy())
        t3 = time.perf_counter()
        prep_ms.append((t2 - t1) * 1e3)
        run_ms.append((t3 - t2) * 1e3)
        if r == 0:
            key, kept = mb.fused_key(), (vals, docs)
            entry, size = B._FUSED_CACHE[key], len(B._FUSED_CACHE)
        elif mb.fused_key() != key or B._FUSED_CACHE.get(key) is not entry \
                or len(B._FUSED_CACHE) != size:
            raise AssertionError(f"serving request {r + 1}: not a hit of request 1's entry")
    total = time.perf_counter() - t_all
    # replays of one graph: docs equal, scores within rtol 1e-5 (a fold's
    # scatter-adds sum in no fixed order)
    np.testing.assert_array_equal(fetched[0][1], fetched[-1][1])
    np.testing.assert_allclose(fetched[0][0].view(np.float32), fetched[-1][0].view(np.float32),
                               rtol=1e-5, atol=0.0)
    again = torch.stack([kept[0].view(torch.int32), kept[1]]).cpu().numpy()
    if not np.array_equal(again, fetched[0]):
        raise AssertionError("serving: request 1's tensors changed under later replays")
    n = SERVE_REQUESTS * len(tasks)
    print(f"serving: {SERVE_REQUESTS} requests of {len(tasks)} queries, each a fresh "
          f"QueryBatch.prepare_all({k}).run() fetched; {SERVE_REQUESTS - 1} of "
          f"{SERVE_REQUESTS} hit request 1's fused entry (no capture); request 1 prepare "
          f"{prep_ms[0]:.4f} ms, run {run_ms[0]:.4f} ms (capture included); requests 2-"
          f"{SERVE_REQUESTS} prepare {[round(x, 4) for x in prep_ms[1:]]} ms, run "
          f"{[round(x, 4) for x in run_ms[1:]]} ms; end to end {n / total:.1f} QPS over all "
          f"{SERVE_REQUESTS} ({total:.4f} s), "
          f"{(n - len(tasks)) / (sum(prep_ms[1:]) + sum(run_ms[1:])) * 1e3:.1f} QPS over "
          f"requests 2-{SERVE_REQUESTS}, on {kind} ({smi})")


def sync_all(torch):
    """Wait for every visible card."""
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def sharded_first_pass(torch, prep, k, what, smi):
    """The first run of a prepared sharded batch on a fresh cache: every
    signature group's miss on every shard (warm-up, capture, replay) under
    PyTorch's sync debug mode set to raise, then one fetch. Prints per
    group its miss ms (warm-up and capture), capture ms, graph nodes,
    launches per replay, the bytes its entry holds (its buffer copies and
    outputs) and what its warm-ups and captures added to the reserve, with
    K3's scored launches on each shard where it has more than one, and
    per card the device bytes the graph pool grew by (reserved after, the
    allocator's cache emptied before and after, less before). Returns
    ((vals, docs) tensors [Q, k], the entries in group order)."""
    from iresearch_tpu_torch.exec import batch as B

    for gi, g in enumerate(prep.groups):
        if prep.fused_key(gi, min(k, prep.searcher.nd_pad, g[3])) in B._FUSED_KINDS["sharded"]:
            raise AssertionError(f"{what}: group {gi} was captured before")
    misses, grew_by = {}, {}
    real = B._FusedPass.capture

    def timed(self, body):
        r = torch.cuda.memory_reserved(self.device)
        t = time.perf_counter()
        real(self, body)
        misses[id(self)] = time.perf_counter() - t
        grew_by[id(self)] = torch.cuda.memory_reserved(self.device) - r

    cards = sorted({d.index for d in prep.searcher.mesh.devices})
    sync_all(torch)
    torch.cuda.empty_cache()
    r0 = {c: torch.cuda.memory_reserved(c) for c in cards}
    B._FusedPass.capture = timed
    t1 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = prep.run(k)
        vals = torch.stack([v for v, _d in out])
        docs = torch.stack([d for _v, d in out])
    finally:
        torch.cuda.set_sync_debug_mode("default")
        B._FusedPass.capture = real
    sync_all(torch)
    first_ms = (time.perf_counter() - t1) * 1e3
    torch.cuda.empty_cache()
    grew = {f"cuda:{c}": torch.cuda.memory_reserved(c) - r0[c] for c in cards}
    cache = B._FUSED_KINDS["sharded"]
    entries = [cache[prep.fused_key(gi, min(k, prep.searcher.nd_pad, g[3]))]
               for gi, g in enumerate(prep.groups)]
    tiers = {qis[0]: t for t, qis, *_r in prep.calls}
    passes = [p for e in entries for p in e.passes]
    for gi, (e, g) in enumerate(zip(entries, prep.groups)):
        own = sum(sum(b.nbytes for b in p.bufs) + p.out.nbytes for p in e.passes)
        launches = sum((Counter(p.launches) for p in e.passes), Counter())
        shards = ("" if len(e.passes) == 1 else
                  f", K3 scored per shard {[p.launches.get('decode_score_rows', 0) for p in e.passes]}")
        print(f"  {what} group {gi} ({tiers[g[0][0]]}, Q={len(g[0])}): miss (warm-up and "
              f"capture) {sum(misses[id(p)] for p in e.passes) * 1e3:.4f} ms, capture "
              f"{sum(p.capture_s for p in e.passes) * 1e3:.4f} ms, "
              f"{sum(p.nodes for p in e.passes)} graph nodes in {len(e.passes)} graph(s), "
              f"launches per replay {dict(launches)}{shards}, entry's own buffers {own} "
              f"bytes, the reserve grew by {sum(grew_by[id(p)] for p in e.passes)} bytes")
    print(f"{what} fused: first pass (every group's warm-up, capture under the sync debug "
          f"mode set to raise, replay) {first_ms:.4f} ms, of it capture "
          f"{sum(p.capture_s for p in passes) * 1e3:.4f} ms host over {len(entries)} "
          f"groups in {len(passes)} graphs, {sum(p.nodes for p in passes)} graph nodes; the "
          f"graph pool and entries grew the reserve by {grew} bytes per card on {smi}")
    return (vals, docs), entries


def run_sharded(torch, srs, tasks, scorer, k, dev, smi, kind, profile, merged):
    """Phase 12: the 400-query mix over the same index through the sharded
    executor, ``ShardedSearcher(srs, device=dev).prepare_many(mix, wand=True,
    k_max=k).run(k)``, one graph replayed per signature group, held against
    its eager run and phase 10's ``prepare_all`` result ``merged``; then
    ``SHARDED_REQUESTS`` fresh ``prepare_many`` requests on an empty cache.
    Returns the launches of one replayed pass and its result (vals, docs)
    as numpy arrays."""
    from iresearch_tpu_torch import bench_mix
    from iresearch_tpu_torch.exec import batch as B
    from iresearch_tpu_torch.exec.phrase import PhraseKeysSpec
    from iresearch_tpu_torch.exec.plan import PlanCompiler
    from iresearch_tpu_torch.kernels import build as kb
    from iresearch_tpu_torch.parallel import ShardedSearcher
    from iresearch_tpu_torch.search import filters as F
    from iresearch_tpu_torch.search.host_eval import HostQuery

    filters = [f for _c, f in tasks]
    t1 = time.perf_counter()
    ss = ShardedSearcher(srs, device=dev)
    prep = ss.prepare_many(filters, scorer, wand=True, k_max=k)
    torch.cuda.synchronize()
    prep_s = time.perf_counter() - t1
    lay = ss._dense_layout("body")
    print(f"sharded: S={ss.S} D={ss.D} per_shard={ss.per_shard} nd_pad={ss.nd_pad}; uniform "
          f"dense layout: {len(lay.terms)} eligible terms, stride {lay.stride} rows, rows per "
          f"class {lay.rows_c}; searcher device bytes {ss.device_bytes} (alive, norms, "
          f"uniform pools; allocated {torch.cuda.memory_allocated(dev)} bytes); prepare "
          f"{prep_s:.3f} s, packed uploads "
          f"{[p[1].nbytes for packs in prep._packs for p in packs if p is not None]} bytes on {smi}")
    tiers = {}
    for t, qis, *_r in prep.calls:
        tiers[id(qis)] = (t, len(qis))
    print(f"sharded groups (tier, queries): {list(tiers.values())}; queries per tier "
          f"{dict(sum((Counter({t: n}) for t, n in tiers.values()), Counter()))}")
    B.clear_fused_cache()
    (vals_t, docs_t), entries = sharded_first_pass(torch, prep, k, "sharded pass", smi)
    # one replayed pass, its launches counted apart: nothing in it may wait
    # for the device
    kb.reset_launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = prep.run(k)
        vals2 = torch.stack([v for v, _d in out])
        docs2 = torch.stack([d for _v, d in out])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    packed = torch.stack([vals2.view(torch.int32), docs2]).cpu().numpy()
    launches = kb.launch_counts()
    if any(e.hits != 1 for e in entries):
        raise AssertionError("sharded pass: the second pass did not hit every group")
    vals, docs = packed[0].view(np.float32), packed[1]
    print(f"sharded pass: {len(entries)} graph replays with no synchronise, one fetch of "
          f"{packed.nbytes} bytes; launches per pass {launches}")
    if launches["decode_score_rows"] <= 0:
        raise AssertionError("K3's scored form never launched in the sharded pass")
    if vals.shape != (len(tasks), k) or not np.isfinite(vals[:, 0]).all():
        raise AssertionError(f"sharded pass: shape {vals.shape} or a query without a hit")
    same_results(torch, [(vals_t, docs_t)], [(vals2, docs2)],
                 "sharded pass: first and second fused run")
    eager = prep.run(k, fused=False)
    same_results(torch, [(vals2, docs2)], [(torch.stack([v for v, _d in eager]),
                                           torch.stack([d for _v, d in eager]))],
                 "sharded pass: fused and eager")
    t1 = time.perf_counter()
    checked = check_sharded(torch, prep, k, "sharded")
    print(f"sharded pass, wrapper calls held against plain: {dict(checked)} "
          f"({time.perf_counter() - t1:.3f} s)")
    for name, n in launches.items():
        if n > checked[name]:
            raise AssertionError(f"kernel {name}: {n} launches in the pass, fewer calls checked")
    plain = prep.run(k, plain=True)
    pv = torch.stack([v for v, _d in plain]).cpu().numpy()
    pd = torch.stack([d for _v, d in plain]).cpu().numpy()
    np.testing.assert_array_equal(docs, pd)
    np.testing.assert_allclose(vals, pv, rtol=1e-5, atol=0.0)
    print(f"sharded pass vs plain-torch run: {len(tasks)} queries match "
          f"({time.perf_counter() - t1:.3f} s since the check began)")
    gv, gd = merged
    for qi in range(len(tasks)):
        fin = np.isfinite(gv[qi])
        assert_gate(vals[qi], docs[qi], gd[qi][fin], gv[qi][fin], f"sharded q{qi} vs prepare_all")
    print(f"sharded pass vs prepare_all: {len(tasks)} queries pass the exactness gate")
    seen = Counter()
    for qi, (cat, flt) in enumerate(tasks):
        if seen[cat] < PER_CATEGORY_ORACLE:
            seen[cat] += 1
            wd, wv = oracle_topk_index(flt, srs, scorer, k)
            assert_gate(vals[qi], docs[qi], wd, wv, f"sharded oracle q{qi} {cat}")
    print(f"sharded oracle (HostQuery over all segments, phase 10's): {sum(seen.values())} "
          f"queries {dict(seen)} pass the exactness gate")
    # phrases in the keys form: the host makes each part's position keys,
    # the device intersects, counts and scores. The three-term phrase takes
    # df ranks 20-22 (phase 9's ranks 10-12 hold 2.4x the positions, and
    # the host's key build, twice per segment, and oracle cost minutes)
    term_at = bench_mix._ranked(srs[0])[0]
    phrases = [("Phrase", bench_mix.breadth_tasks(srs[0])[0][1]),
               ("Phrase3Gap", F.ByPhrase("body", [term_at(20), term_at(21), (1, term_at(22))]))]
    for name, flt in phrases:
        # the plan of the smallest segment (the keys form is all or none:
        # prepare_many falls to host aux unless every segment has one)
        comp = PlanCompiler(HostQuery(flt, ss._wrapped_segments(), scorer), scorer)
        plan = comp.compile(flt, len(srs) - 1, device_phrase="keys", dense=True)
        if not plan.device_aux or not isinstance(plan.device_aux[0][1], PhraseKeysSpec):
            raise AssertionError(f"sharded {name}: the plan has no PhraseKeysSpec row")
        t1 = time.perf_counter()
        pp = ss.prepare_many([flt], scorer, wand=True, k_max=k)
        ph_prep = time.perf_counter() - t1
        if not all(kw.get("phrase_keys") for _t, _q, _f, _a, kw in pp.calls):
            raise AssertionError(f"sharded {name}: the keys form did not run")
        pp.run(k)  # the miss: warm-up, capture, replay
        kb.reset_launch_counts()
        got = pp.run(k)[0]
        torch.cuda.synchronize()
        ph_launches = {n: c for n, c in kb.launch_counts().items() if c}
        check_calls(torch, pp, f"sharded {name}")
        eager = pp.run(k, fused=False)[0]
        same_results(torch, [got], [eager], f"sharded {name}: fused and eager")
        plain = pp.run(k, plain=True)[0]
        wd, wv = oracle_topk_index(flt, srs, scorer, k)
        gv_, gd_ = (t.cpu().numpy() for t in got)
        pv_, pd_ = (t.cpu().numpy() for t in plain)
        np.testing.assert_array_equal(gd_, pd_)
        np.testing.assert_allclose(gv_, pv_, rtol=1e-5, atol=0.0)
        assert_gate(gv_, gd_, wd, wv, f"sharded {name} vs oracle")
        ph_all = time.perf_counter() - t1
        nkeys = [len(sp.part_keys64[m]) for _a, sp in plan.device_aux for m in range(len(sp.part_keys64))]
        print(f"sharded {name}: keys form in every segment's call, PhraseKeysSpec rows "
              f"(smallest segment's keys per part {nkeys}), {int(np.isfinite(gv_).sum())} "
              f"hits equal plain and the oracle; prepare {ph_prep:.3f} s (with the checks "
              f"{ph_all:.3f} s), launches per replay {ph_launches}, "
              f"{sync_ms(torch, lambda: pp.run(k)):.4f} ms/query fused, "
              f"{sync_ms(torch, lambda: pp.run(k, fused=False)):.4f} eager, synchronised "
              f"({SINGLE_REPS} runs) on {smi}")

    both_ways(torch, lambda fused: prep.run(k, fused=fused), len(tasks), "sharded passes",
              smi, kind, passes=SHARDED_PASSES)
    if profile:
        for fused in (True, False):
            profile_passes(torch, lambda: prep.run(k, fused=fused),
                           f"{profile}.sharded.{'fused' if fused else 'eager'}", kind, smi,
                           passes=1)
    run_sharded_serving(torch, ss, filters, scorer, k, smi, kind)
    one = ss.prepare(tasks[0][1], scorer, k_max=k)
    print(f"sharded single query (prepare, {len(srs)} segments + merge): "
          f"{sync_ms(torch, lambda: one.run(k)):.4f} ms/query fused, "
          f"{sync_ms(torch, lambda: one.run(k, fused=False)):.4f} eager, synchronised "
          f"({SINGLE_REPS} runs) on {smi}")
    return launches, (vals, docs)


def run_sharded_serving(torch, ss, filters, scorer, k, smi, kind):
    """Phase 12, serving: ``SHARDED_REQUESTS`` fresh ``prepare_many``
    requests of the mix on an empty fused cache, each run and fetched.
    Request 1 captures every group; each later one must hit every group's
    entry (no capture); request 1's tensors must be unchanged after the
    last, and its result equal the last one's (docs equal, scores rtol
    1e-5). Prints prepare and run ms per request and the QPS."""
    from iresearch_tpu_torch.exec import batch as B

    B.clear_fused_cache()
    torch.cuda.synchronize()
    prep_ms, run_ms, fetched, kept, entries = [], [], [], None, None
    for r in range(SHARDED_REQUESTS):
        t1 = time.perf_counter()
        prep = ss.prepare_many(filters, scorer, wand=True, k_max=k)
        t2 = time.perf_counter()
        out = prep.run(k)
        vals = torch.stack([v for v, _d in out])
        docs = torch.stack([d for _v, d in out])
        fetched.append(torch.stack([vals.view(torch.int32), docs]).cpu().numpy())
        t3 = time.perf_counter()
        prep_ms.append((t2 - t1) * 1e3)
        run_ms.append((t3 - t2) * 1e3)
        cache = B._FUSED_KINDS["sharded"]
        mine = [cache.get(prep.fused_key(gi, min(k, ss.nd_pad, g[3])))
                for gi, g in enumerate(prep.groups)]
        if r == 0:
            kept, entries = (vals, docs), mine
        elif mine != entries or any(e.hits != r for e in entries) or len(cache) != len(entries):
            raise AssertionError(f"sharded serving request {r + 1}: not a hit on every group")
    np.testing.assert_array_equal(fetched[0][1], fetched[-1][1])
    np.testing.assert_allclose(fetched[0][0].view(np.float32), fetched[-1][0].view(np.float32),
                               rtol=1e-5, atol=0.0)
    again = torch.stack([kept[0].view(torch.int32), kept[1]]).cpu().numpy()
    if not np.array_equal(again, fetched[0]):
        raise AssertionError("sharded serving: request 1's tensors changed under later replays")
    n = len(filters)
    print(f"sharded serving: {SHARDED_REQUESTS} requests of {n} queries, each a fresh "
          f"prepare_many(...).run({k}) fetched; every group of requests 2-{SHARDED_REQUESTS} "
          f"hit request 1's entries ({len(entries)} groups, no capture); request 1 prepare "
          f"{prep_ms[0]:.4f} ms, run {run_ms[0]:.4f} ms (captures included); requests 2-"
          f"{SHARDED_REQUESTS} prepare {[round(x, 4) for x in prep_ms[1:]]} ms, run "
          f"{[round(x, 4) for x in run_ms[1:]]} ms; "
          f"{(n * (SHARDED_REQUESTS - 1)) / (sum(prep_ms[1:]) + sum(run_ms[1:])) * 1e3:.1f} "
          f"QPS over requests 2-{SHARDED_REQUESTS} on {kind} ({smi})")


def mesh_of_cards(torch):
    """Phase 17's mesh: every visible card, one shard each, where there are
    two or more; else four shards on cuda:0."""
    n = torch.cuda.device_count()
    if n >= 2:
        return [torch.device("cuda", i) for i in range(n)]
    return [torch.device("cuda", 0)] * MESH_SHARDS_ONE_CARD


def run_mesh(torch, srs, tasks, scorer, k, smi, kind, merged, one_shard, profile):
    """Phase 17: the 400-query mix over phase 10's index through a mesh of
    devices, ``ShardedSearcher(srs, devices=mesh_of_cards()).prepare_many(
    mix, wand=True, k_max=k).run(k)``: one graph per signature group and
    shard, the shards' candidates gathered onto the first card. The first
    pass captures every group on every shard under the sync debug mode (as
    in phase 12); the second only replays, with no synchronise, and K3's
    scored form must launch on every shard that holds a segment; every
    wrapper call of every shard is held bit for bit against its plain
    version; the result against the first pass, the eager pass, phase
    12's one-shard result ``one_shard`` (docs equal, scores rtol 1e-5) and
    phase 10's ``prepare_all`` result ``merged`` (the exactness gate).
    Then the gather alone (copies onto the first card, concat, re-rank:
    ms between events with its inputs ready), ``MESH_PASSES`` timed passes
    each way and JAX's ``dryrun_multichip`` on the same devices
    (``run_mesh_dryrun``). Returns the launches of one replayed pass and
    of the dryrun, summed, the launches of the pass alone and its result
    (vals, docs) as numpy arrays."""
    from iresearch_tpu_torch.exec import batch as B
    from iresearch_tpu_torch.kernels import build as kb
    from iresearch_tpu_torch.parallel import ShardedSearcher

    B.clear_fused_cache()
    devices = mesh_of_cards(torch)
    cards = sorted({d.index for d in devices})
    filters = [f for _c, f in tasks]
    t1 = time.perf_counter()
    ss = ShardedSearcher(srs, devices=devices)
    prep = ss.prepare_many(filters, scorer, wand=True, k_max=k)
    sync_all(torch)
    prep_s = time.perf_counter() - t1
    print(f"mesh: {len(cards)} distinct card(s) {cards}, {ss.D} shards (S={ss.S}, per_shard="
          f"{ss.per_shard}); shards (index, device, segments) "
          f"{[(g, str(d), segs) for g, d, segs in ss.shards]}; searcher device bytes "
          f"{ss.device_bytes}; prepare {prep_s:.3f} s, "
          f"{sum(p is not None for packs in prep._packs for p in packs)} packed uploads on {smi}")
    (vals_t, docs_t), entries = sharded_first_pass(torch, prep, k, "mesh pass", smi)
    kb.reset_launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = prep.run(k)
        vals2 = torch.stack([v for v, _d in out])
        docs2 = torch.stack([d for _v, d in out])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    packed = torch.stack([vals2.view(torch.int32), docs2]).cpu().numpy()
    launches = kb.launch_counts()
    if any(e.hits != 1 for e in entries):
        raise AssertionError("mesh pass: the second pass did not hit every group")
    live = [(g, d) for g, d, segs in ss.shards if segs]
    k3 = Counter()
    for e in entries:
        for (g, d), p in zip(live, e.passes):
            if p.device != d:
                raise AssertionError(f"mesh: shard {g}'s graph on {p.device}, not {d}")
            k3[f"shard {g} on {d}"] += p.launches.get("decode_score_rows", 0)
    print(f"mesh pass: {sum(len(e.passes) for e in entries)} graph replays over "
          f"{len(entries)} groups with no synchronise, one fetch of {packed.nbytes} bytes on "
          f"{vals2.device}; launches per pass {launches}; K3 scored per shard {dict(k3)}")
    if len(k3) != len(live) or not all(k3.values()):
        raise AssertionError(f"mesh: K3's scored form did not launch on every shard: {dict(k3)}")
    if vals2.device != devices[0] or packed.shape[1:] != (len(tasks), k):
        raise AssertionError(f"mesh pass: on {vals2.device}, shape {packed.shape}")
    same_results(torch, [(vals_t, docs_t)], [(vals2, docs2)], "mesh pass: first and second fused run")
    eager = prep.run(k, fused=False)
    same_results(torch, [(vals2, docs2)], [(torch.stack([v for v, _d in eager]),
                                           torch.stack([d for _v, d in eager]))],
                 "mesh pass: fused and eager")
    vals, docs = packed[0].view(np.float32), packed[1]
    np.testing.assert_array_equal(docs, one_shard[1])
    np.testing.assert_allclose(vals, one_shard[0], rtol=1e-5, atol=0.0)
    print(f"mesh pass vs phase 12's one-shard pass: {len(tasks)} queries, docs equal, scores "
          f"bit-equal in {int((vals.view(np.int32) == one_shard[0].view(np.int32)).all(1).sum())}"
          f" of {len(tasks)} queries, the others within rtol 1e-5")
    gv, gd = merged
    for qi in range(len(tasks)):
        fin = np.isfinite(gv[qi])
        assert_gate(vals[qi], docs[qi], gd[qi][fin], gv[qi][fin], f"mesh q{qi} vs prepare_all")
    print(f"mesh pass vs prepare_all: {len(tasks)} queries pass the exactness gate")
    t1 = time.perf_counter()
    checked = check_sharded(torch, prep, k, "mesh, every shard")
    print(f"mesh pass, wrapper calls of every shard held against plain: {dict(checked)} "
          f"({time.perf_counter() - t1:.3f} s)")
    for name, n in launches.items():
        if n > checked[name]:
            raise AssertionError(f"kernel {name}: {n} launches in the mesh pass, fewer checked")
    # the gather alone: every group's shard candidates of one pass, copied
    # onto the first card, concatenated and re-ranked, inputs ready
    joins = []
    real = ss._join
    ss._join = lambda *a: joins.append(a) or real(*a)
    try:
        prep.run(k)
    finally:
        del ss._join
    sync_all(torch)
    if ss.D > 1:
        gather = cuda_ms(torch, lambda: [real(*a) for a in joins], iters=10)
        print(f"mesh gather (copies of {sum(o[0].nbytes + o[1].nbytes for a in joins for o in a[0] if o is not None)} "
              f"candidate bytes onto {devices[0]}, concat, re-rank; {len(joins)} groups): "
              f"{gather:.4f} ms a pass between events on {smi}")
    both_ways(torch, lambda fused: prep.run(k, fused=fused), len(tasks), "mesh passes", smi,
              kind, passes=MESH_PASSES)
    if profile:
        for fused in (True, False):
            profile_passes(torch, lambda: prep.run(k, fused=fused),
                           f"{profile}.mesh.{'fused' if fused else 'eager'}", kind, smi, passes=1)
    del prep, ss, eager, out
    B.clear_fused_cache()
    return Counter(launches) + run_mesh_dryrun(torch, devices, smi), launches, (vals, docs)


def run_mesh_dryrun(torch, devices, smi):
    """Phase 17, the JAX package's ``dryrun_multichip`` on the mesh's
    devices: 256 docs a segment, one segment a shard
    (``parallel/multihost.py:_build_reader``, the port's own writer), the
    uniform dense layout active, a search through ``search_arrays``, then
    term, WAND Or, min-match, And, phrase and gridmix queries in one
    ``prepare_many(wand=True)``: the top-5 against the host oracle, fused
    against eager, every wrapper call held against plain. Returns the
    launches of the fused run."""
    from iresearch_tpu_torch.exec import batch as B
    from iresearch_tpu_torch.kernels import build as kb
    from iresearch_tpu_torch.parallel import ShardedSearcher
    from iresearch_tpu_torch.parallel.multihost import _build_reader
    from iresearch_tpu_torch.search import filters as F
    from iresearch_tpu_torch.search.host_eval import search as host_search
    from iresearch_tpu_torch.search.scorers import BM25

    t1 = time.perf_counter()
    D = len(devices)
    reader = _build_reader(num_docs=256 * D, segments=D)
    ss = ShardedSearcher(list(reader.segments), devices=devices)
    if (ss.D, ss.per_shard) != (D, 1) or not ss._dense_layout("body").terms:
        raise AssertionError(f"mesh dryrun: D={ss.D}, per_shard={ss.per_shard}, no dense grid?")
    vals, _docs = ss.search_arrays(F.Or(F.ByTerm("body", "alpha"), F.ByTerm("body", "beta")),
                                   BM25(), k=5)
    if vals.shape != (5,) or not math.isfinite(float(vals[0])):
        raise AssertionError(f"mesh dryrun: search_arrays gave {vals}")
    queries = [
        F.ByTerm("body", "alpha"),
        F.Or(*[F.ByTerm("body", w) for w in ("alpha", "beta", "gamma", "delta")]),
        F.Or(F.ByTerm("body", "alpha"), F.ByTerm("body", "beta"),
             F.ByTerm("body", "gamma"), min_match=2),
        F.And(F.ByTerm("body", "alpha"), F.ByTerm("body", "beta")),
        F.ByPhrase("body", ["alpha", "beta"]),
        F.Or(F.ByTerm("body", "alpha"), F.ByTerm("body", "pi")),
    ]
    prep = ss.prepare_many(queries, BM25(), wand=True)
    prep.run(5)  # the captures
    kb.reset_launch_counts()
    got = prep.top_k(5)
    launches = kb.launch_counts()
    for q, hits in zip(queries, got):
        want = host_search(reader, q, k=5)
        assert_gate(np.array([v for _d, v in hits], np.float32), np.array([d for d, _v in hits]),
                    np.array([d for d, _v in want]), np.array([v for _d, v in want], np.float32),
                    f"mesh dryrun {q}")
    same_results(torch, [tuple(torch.stack(x) for x in zip(*prep.run(5)))],
                 [tuple(torch.stack(x) for x in zip(*prep.run(5, fused=False)))],
                 "mesh dryrun: fused and eager")
    checked = check_calls(torch, prep, "mesh dryrun")
    tiers = sorted({c[0] for c in prep.calls})
    print(f"mesh dryrun (JAX's dryrun_multichip): {len(reader.segments)} segments of 256 docs "
          f"over {D} shards on {sorted({str(d) for d in devices})}, {len(queries)} queries in "
          f"tiers {tiers}: the top-5 of each passes the gate against the host oracle; "
          f"launches {launches}, wrapper calls checked {dict(checked)}; "
          f"{time.perf_counter() - t1:.3f} s on {smi}")
    B.clear_fused_cache()
    return Counter(launches)


def free_port():
    """A free TCP port on 127.0.0.1."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_nccl(torch, srs, paths, tasks, scorer, k, smi, kind, mesh_launches, mesh_out,
             one_shard):
    """Phase 19: the 400-query mix over phase 10's index through an NCCL
    group of one process, opened here on cuda:0 (``tcp://127.0.0.1``, rank
    0 of 1, the communicator made at once) and passed as ``group=``:
    ``ShardedSearcher(srs, group=..., devices=[cuda:0] * NCCL_SHARDS)``
    over the resident segments, one CUDA graph per signature group holding
    every shard's runners, the all_gather and the re-rank. The first pass
    captures them under the sync debug mode set to raise; the second only
    replays, with no synchronise and no call into ``torch.distributed``,
    and launches what phase 17's pass ``mesh_launches`` launched; K3's
    scored form per group graph printed; every wrapper call held bit for
    bit against its plain version; the result against the first pass,
    the eager pass, phase 17's ``mesh_out`` and phase 12's ``one_shard``
    (docs equal, scores rtol 1e-5, bit-equality counted); the joins alone
    (copies, concat, all_gather, re-rank, between events); ``MESH_PASSES``
    timed passes each way. The group is destroyed, its graphs freed first.
    Where two or more cards are visible, ``run_nccl_workers`` over the
    segment files ``paths``. Returns the launches of the replayed pass
    (and of the workers' replays)."""
    import torch.distributed as dist

    from iresearch_tpu_torch.exec import batch as B
    from iresearch_tpu_torch.kernels import build as kb
    from iresearch_tpu_torch.parallel import ShardedSearcher
    from iresearch_tpu_torch.parallel.multihost import dist_calls

    B.clear_fused_cache()
    dev = torch.device("cuda", 0)
    filters = [f for _c, f in tasks]
    t1 = time.perf_counter()
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}", rank=0,
                            world_size=1, device_id=dev)
    init_s = time.perf_counter() - t1
    try:
        t1 = time.perf_counter()
        ss = ShardedSearcher(srs, group=dist.group.WORLD, devices=[dev] * NCCL_SHARDS)
        prep = ss.prepare_many(filters, scorer, wand=True, k_max=k)
        sync_all(torch)
        prep_s = time.perf_counter() - t1
        if not (ss.mesh.join_in_graph and ss.mesh.world == 1 and ss.D == NCCL_SHARDS):
            raise AssertionError(f"nccl: mesh {ss.mesh} (join in graph "
                                 f"{ss.mesh.join_in_graph}), D={ss.D}")
        print(f"nccl: a group of one process over {dist.get_backend(ss.mesh.group)} (made in "
              f"{init_s:.3f} s), {ss.D} shards on {dev}; shards (index, device, segments) "
              f"{[(g, str(d), segs) for g, d, segs in ss.shards]}; prepare {prep_s:.3f} s")
        (vals_t, docs_t), entries = sharded_first_pass(torch, prep, k, "nccl pass", smi)
        if any(len(e.passes) != 1 or e.passes[0].graph is None or e.passes[0].device != dev
               for e in entries):
            raise AssertionError("nccl: a group is not one captured graph on cuda:0")
        kb.reset_launch_counts()
        torch.cuda.set_sync_debug_mode("error")
        try:
            with dist_calls() as calls:
                out = prep.run(k)
                vals2 = torch.stack([v for v, _d in out])
                docs2 = torch.stack([d for _v, d in out])
        finally:
            torch.cuda.set_sync_debug_mode("default")
        packed = torch.stack([vals2.view(torch.int32), docs2]).cpu().numpy()
        launches = kb.launch_counts()
        k3 = [e.passes[0].launches.get("decode_score_rows", 0) for e in entries]
        print(f"nccl pass: {len(entries)} graph replays (one a group: runners, all_gather, "
              f"re-rank) with no synchronise and {sum(calls.values())} calls into "
              f"torch.distributed; launches per pass {launches}; K3 scored per group graph "
              f"{k3}; graph nodes per group {[e.passes[0].nodes for e in entries]}")
        if sum(calls.values()) or any(e.hits != 1 for e in entries):
            raise AssertionError(f"nccl: the replays called {dict(calls)} or missed a group")
        if launches != mesh_launches or not launches.get("decode_score_rows") \
                or sum(k3) != launches["decode_score_rows"]:
            raise AssertionError(f"nccl: launches {launches} against phase 17's {mesh_launches}")
        same_results(torch, [(vals_t, docs_t)], [(vals2, docs2)],
                     "nccl pass: first and second fused run")
        eager = prep.run(k, fused=False)
        same_results(torch, [(vals2, docs2)], [(torch.stack([v for v, _d in eager]),
                                               torch.stack([d for _v, d in eager]))],
                     "nccl pass: fused and eager")
        vals, docs = packed[0].view(np.float32), packed[1]
        for (wv, wd), what in ((mesh_out, "phase 17's mesh pass"),
                               (one_shard, "phase 12's one-shard pass")):
            np.testing.assert_array_equal(docs, wd)
            np.testing.assert_allclose(vals, wv, rtol=1e-5, atol=0.0)
            print(f"nccl pass vs {what}: {len(tasks)} queries, docs equal, scores bit-equal in "
                  f"{int((vals.view(np.int32) == wv.view(np.int32)).all(1).sum())} of "
                  f"{len(tasks)} queries, the others within rtol 1e-5")
        t1 = time.perf_counter()
        checked = check_sharded(torch, prep, k, "nccl, every shard")
        print(f"nccl pass, wrapper calls held against plain: {dict(checked)} "
              f"({time.perf_counter() - t1:.3f} s)")
        for name, n in launches.items():
            if n > checked[name]:
                raise AssertionError(f"kernel {name}: {n} launches in the nccl pass, fewer checked")
        # the joins alone: every group's shard candidates of one eager pass,
        # copied, concatenated, gathered over NCCL and re-ranked
        joins = []
        real = ss._join
        ss._join = lambda *a: joins.append(a) or real(*a)
        try:
            prep.run(k, fused=False)
        finally:
            del ss._join
        sync_all(torch)
        join_ms = cuda_ms(torch, lambda: [real(*a) for a in joins], iters=10)
        ms = both_ways(torch, lambda fused: prep.run(k, fused=fused), len(tasks), "nccl passes",
                       smi, kind, passes=MESH_PASSES)
        print(f"nccl joins ({len(joins)} groups: copies, concat, all_gather, re-rank): "
              f"{join_ms:.4f} ms a pass between events, {join_ms / min(ms[True]):.4f} of the "
              f"fastest fused pass, on {smi}")
        del prep, ss, eager, out
    finally:
        B.clear_fused_cache()  # no graph outlives the communicator it holds
        dist.destroy_process_group()
    if torch.cuda.device_count() >= 2:
        return Counter(launches) + run_nccl_workers(torch, paths, (vals, docs), smi)
    return Counter(launches)


def run_nccl_workers(torch, paths, want, smi):
    """Phase 19 over every visible card: one process per card in an NCCL
    group (``parallel/multihost.py:serve_multihost``), each opening the
    segment files ``paths`` and holding its shard on its card, serving the
    mix (the first pass captures, the second replays with no call into
    ``torch.distributed``; ``SERVE_PASSES`` passes each way, the busy share
    of its card under the profiler). Every rank's result against the
    one-card result ``want`` (docs equal, scores rtol 1e-5). Returns the
    workers' launches of their replayed pass, summed."""
    from iresearch_tpu_torch.exec import batch as B
    from iresearch_tpu_torch.parallel.multihost import serve_multihost

    B.clear_fused_cache()
    torch.cuda.empty_cache()
    n = torch.cuda.device_count()
    t1 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="nccl_", dir=os.path.dirname(paths[0])) as out:
        outs, results = serve_multihost(paths, n, out)
    total = Counter()
    for pid, (log, got) in enumerate(zip(outs, results)):
        join = re.search(rf"^MULTIHOST_JOIN process={pid} .*$", log, re.M)
        line = re.search(rf"^MULTIHOST_INDEX process={pid} .* launches=(.*)$", log, re.M)
        if join is None or line is None or " join=graph " not in join.group(0) \
                or " dist_calls=0 " not in join.group(0):
            raise AssertionError(f"nccl worker {pid}:\n{log[-3000:]}")
        print(f"nccl worker {pid}: {join.group(0)}")
        print(f"nccl worker {pid}: {line.group(0)}")
        vals, docs = got[0].view(np.float32), got[1]
        np.testing.assert_array_equal(docs, want[1])
        np.testing.assert_allclose(vals, want[0], rtol=1e-5, atol=0.0)
        print(f"nccl worker {pid}: its result equals the one-card result (docs equal, scores "
              f"bit-equal in {int((vals.view(np.int32) == want[0].view(np.int32)).all(1).sum())}"
              f" of {len(docs)} queries)")
        total.update(json.loads(line.group(1)))
    print(f"nccl workers: {n} processes, one card each, {time.perf_counter() - t1:.3f} s on {smi}")
    return total


def run_invert(torch, num_docs, seed, dev, smi):
    """Phase 11: ``invert_device`` on the card against ``invert_numpy``."""
    import dataclasses

    from iresearch_tpu_torch import bench_mix
    from iresearch_tpu_torch.index.invert import invert_device, invert_numpy

    tids, doc, pos = bench_mix.token_stream(num_docs, seed)
    t1 = time.perf_counter()
    want = invert_numpy(tids, doc, pos, bench_mix.VOCAB, num_docs)
    host_s = time.perf_counter() - t1
    invert_device(tids[:1000], doc[:1000], pos[:1000], bench_mix.VOCAB, num_docs, device=dev)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    got = invert_device(tids, doc, pos, bench_mix.VOCAB, num_docs, device=dev)
    torch.cuda.synchronize()
    dev_s = time.perf_counter() - t1
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if a.dtype != b.dtype or a.shape != b.shape:
            raise AssertionError(f"invert_device {f.name}: {a.dtype}{a.shape} vs {b.dtype}{b.shape}")
        np.testing.assert_array_equal(a, b, err_msg=f"invert_device {f.name}")
    print(f"invert: {len(tids)} tokens of {num_docs} docs (seed {seed}), {len(want.e_doc)} "
          f"entries: invert_device equals invert_numpy field by field; "
          f"{dev_s:.3f} s on the device (upload and fetch included), {host_s:.3f} s "
          f"invert_numpy on the host, on {smi}")


def same_field(got, want, what):
    """Every array, pool and scalar of two ``FieldPostings`` equal."""
    import dataclasses

    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        seq = isinstance(b, (tuple, list))
        if seq and len(a) != len(b):
            raise AssertionError(f"{what} {f.name}: {len(a)} vs {len(b)} pools")
        for i, (x, y) in enumerate(zip(a, b) if seq else [(a, b)]):
            name = f"{what} {f.name}{f'[{i}]' if seq else ''}"
            if isinstance(y, np.ndarray):
                if x.dtype != y.dtype or x.shape != y.shape:
                    raise AssertionError(f"{name}: {x.dtype}{x.shape} vs {y.dtype}{y.shape}")
                np.testing.assert_array_equal(x, y, err_msg=name)
            elif isinstance(y, (bytes, bytearray, memoryview)):
                if bytes(x) != bytes(y):
                    raise AssertionError(f"{name}: bytes differ")
            elif x != y:
                raise AssertionError(f"{name}: {x!r} vs {y!r}")


def run_ingest(torch, num_docs, want, dev, smi):
    """Phase 13, steps 1-4: the corpus as text through the port's
    ``IndexWriter`` (default options: ``"auto"`` inverts on the card),
    committed, consolidated and a delete applied; the consolidated "body"
    field held against ``want`` (phase 10's segment of the same seed).
    Returns the reader after the delete and the removed term."""
    from iresearch_tpu_torch import bench_mix
    from iresearch_tpu_torch.formats.segment_io import CURRENT_FORMAT, write_segment
    from iresearch_tpu_torch.index.consolidate import consolidate_count
    from iresearch_tpu_torch.index.reader import DirectoryReader
    from iresearch_tpu_torch.index.writer import Field, IndexWriter, IndexWriterOptions
    from iresearch_tpu_torch.search import filters as F
    from iresearch_tpu_torch.store.directory import MemoryDirectory

    t1 = time.perf_counter()
    buf, starts, ends = bench_mix.corpus_text(num_docs, bench_mix.SEED + 1)
    ntok = len(buf) // 8
    print(f"ingest corpus: {num_docs} docs, {ntok} tokens, {len(buf)} bytes of text "
          f"(seed {bench_mix.SEED + 1}) in {time.perf_counter() - t1:.3f} s")
    opts = IndexWriterOptions()
    if opts.invert_backend != "auto" or opts.format_version != CURRENT_FORMAT:
        raise AssertionError(f"writer defaults {opts}")
    d = MemoryDirectory()
    w = IndexWriter(d, opts, device=dev)
    with scoped_clock() as calls:
        t1 = time.perf_counter()
        for s, e in zip(starts.tolist(), ends.tolist()):
            w.insert([Field("body", buf[s:e].decode(), analyzer="segmentation")])
        insert_s = time.perf_counter() - t1
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        t1 = time.perf_counter()
        if not w.commit():
            raise AssertionError("commit published nothing")
        commit_s = time.perf_counter() - t1
        peak = torch.cuda.max_memory_allocated(dev)
    del buf
    flush_s = [t for n, t, _th in calls if n == "writer.flush"]
    invert_s = [t for n, t, _th in calls if n == "writer.invert"]
    cap = opts.segment_docs_max
    sizes = [cap] * (num_docs // cap) + ([num_docs % cap] if num_docs % cap else [])
    if len(flush_s) != len(sizes) or len(invert_s) != len(sizes):
        raise AssertionError(f"{len(flush_s)} flushes, {len(invert_s)} inversions, "
                             f"expected {len(sizes)}")
    print(f"ingest: {num_docs / insert_s:.1f} docs/s, {ntok / insert_s:.1f} tokens/s "
          f"({insert_s:.3f} s of inserts from one thread, analyzer 'segmentation'); "
          f"commit {commit_s:.3f} s on {smi}")
    for i, (fs, inv) in enumerate(zip(flush_s, invert_s)):
        print(f"  flush {i} ({sizes[i]} docs): {fs:.3f} s, of it invert_device {inv:.3f} s "
              f"(upload and fetch included) and the rest (streams, term sort, encode, "
              f"columns) {fs - inv:.3f} s, on {smi}")
    print(f"  flushes' peak device memory: {peak} bytes allocated "
          f"({peak - base} above the {base} bytes resident before the commit), on {smi}")

    t1 = time.perf_counter()
    r = DirectoryReader.open(d)
    open_s = time.perf_counter() - t1
    got = [(sr.num_docs, sr.live_docs_count) for sr in r.segments]
    if got != [(n, n) for n in sizes]:
        raise AssertionError(f"segments {got}, expected {sizes} live docs")
    t1 = time.perf_counter()
    if not w.consolidate(consolidate_count()):
        raise AssertionError("consolidate merged nothing")
    w.commit()
    cons_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    r = DirectoryReader.open(d)
    reopen_s = time.perf_counter() - t1
    if [sr.num_docs for sr in r.segments] != [num_docs]:
        raise AssertionError(f"consolidated segments {[sr.num_docs for sr in r.segments]}")
    data = r.segments[0].data
    if list(data.fields) != ["body"] or data.columns or data.num_docs != want.num_docs:
        raise AssertionError(f"consolidated segment: {list(data.fields)}, {list(data.columns)}")
    same_field(data.fields["body"], want.fields["body"], "consolidated body")
    file_bytes = d.read(r.meta.segments[0].file)
    if bytes(file_bytes) != bytes(write_segment(want)):
        raise AssertionError("consolidated segment file differs from phase 10's segment")
    print(f"open {open_s:.3f} s ({len(sizes)} segments {sizes}); consolidate {cons_s:.3f} s; "
          f"reopen {reopen_s:.3f} s; the consolidated 'body' field equals phase 10's "
          f"segment of seed {bench_mix.SEED + 1} array for array and its file "
          f"({len(file_bytes)} bytes, {CURRENT_FORMAT}) byte for byte, on {smi}")

    # the df-rank-2000 term: the mix's first LowTerm query
    term = next(f.term for c, f in bench_mix.task_mix(r.segments[0]) if c == "LowTerm")
    df = int(data.fields["body"].entries[r.segments[0].lookup_term("body", term), 0])
    t1 = time.perf_counter()
    w.remove(F.ByTerm("body", term))
    w.commit()
    delete_s = time.perf_counter() - t1
    w.close()
    r = DirectoryReader.open(d)
    sr = r.segments[0]
    ndead = sr.num_docs - sr.live_docs_count
    if ndead != df or ndead == 0:
        raise AssertionError(f"delete of {term!r}: {ndead} docs masked")
    print(f"delete of {term!r} (df rank 2000): {ndead} docs masked, remove + commit "
          f"{delete_s:.3f} s on {smi}")
    return r, term


def serve_ingested(torch, reader, term, scorer, k, dev, smi, kind):
    """Phase 13, step 5: the 400-query mix over the written index through
    ``prepare_all(k).run()``, held against plain, the oracle and, call by
    call, the kernels' plain versions. Returns the pass's launches."""
    from iresearch_tpu_torch import bench_mix
    from iresearch_tpu_torch.exec.batch import QueryBatch
    from iresearch_tpu_torch.kernels import build as kb
    from iresearch_tpu_torch.search import filters as F

    srs = reader.segments
    tasks = bench_mix.task_mix(srs[0])
    filters = [f for _c, f in tasks]
    mb = QueryBatch(filters, srs, scorer, wand=True, device=dev).prepare_all(k)
    torch.cuda.synchronize()
    for s, p in enumerate(mb.preps):
        print(f"  ingested segment {s}: groups per tier {dict(Counter(c[0] for c in p.calls))}")
    first, (vals_t, docs_t), _entry, _stats = first_fused(torch, mb.run, "batch", mb.fused_key(),
                                                          "ingested index pass", smi)
    packed = torch.stack([vals_t.view(torch.int32), docs_t]).cpu().numpy()
    launches = kb.launch_counts()
    vals, docs = packed[0].view(np.float32), packed[1]
    print(f"ingested index pass: enqueued with no synchronise; launches {launches}")
    same_results(torch, [first], [(vals_t, docs_t)], "ingested pass: first and second fused run")
    same_results(torch, [(vals_t, docs_t)], [mb.run(fused=False)], "ingested pass: fused and eager")
    for name in ("dense_scan_rowmax", "dma_row_slices", "decode_score_rows"):
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} never launched over the ingested index")
    # every query has a hit but the removed term's (the first LowTerm query)
    gone = {qi for qi, (_c, f) in enumerate(tasks) if f == F.ByTerm("body", term)}
    hitless = set(np.flatnonzero(~np.isfinite(vals[:, 0])).tolist())
    if vals.shape != (len(tasks), k) or not gone or hitless != gone:
        raise AssertionError(f"ingested pass: shape {vals.shape}, queries without a hit "
                             f"{sorted(hitless)}, of the removed term {sorted(gone)}")
    checked = sum((check_calls(torch, p, f"ingested segment {s}")
                   for s, p in enumerate(mb.preps)), Counter())
    checked += check_merge(mb, "ingested pass")
    for name, n in launches.items():
        if n > checked[name]:
            raise AssertionError(f"kernel {name}: {n} launches in the pass, fewer calls checked")
    pv, pd = (t.cpu().numpy() for t in mb.run(plain=True))
    np.testing.assert_array_equal(docs, pd)
    np.testing.assert_allclose(vals, pv, rtol=1e-5, atol=0.0)
    print(f"ingested pass vs plain-torch run: {len(tasks)} queries match")
    alive = np.concatenate([sr.alive for sr in srs])
    seen = Counter()
    for qi, (cat, flt) in enumerate(tasks):
        fin = np.isfinite(vals[qi])
        if not alive[docs[qi][fin]].all():
            raise AssertionError(f"q{qi}: a deleted doc returned")
        if seen[cat] < PER_CATEGORY_ORACLE:
            seen[cat] += 1
            wd, wv = oracle_topk_index(flt, srs, scorer, k)
            assert_gate(vals[qi], docs[qi], wd, wv, f"ingested oracle q{qi} {cat}")
    alone = QueryBatch([F.ByTerm("body", term)], srs, scorer, device=dev).prepare_all(k)
    if np.isfinite(alone.run()[0].cpu().numpy()).any():
        raise AssertionError(f"the removed term {term!r} still matches")
    print(f"ingested oracle (HostQuery over the written index): {sum(seen.values())} queries "
          f"{dict(seen)} pass the exactness gate; no deleted doc in any of the "
          f"{len(tasks)} results; the removed term matches nothing (queries {sorted(gone)})")
    ms = pass_ms(torch, mb.run)
    prof = profile_passes(torch, mb.run, os.path.join(REPO, ".bench_cache", "ingest_profile.txt"),
                          kind, smi)
    print(f"ingested index passes: {PASSES} x {len(tasks)} queries, {ms:.4f} ms/pass -> "
          f"{len(tasks) / ms * 1e3:.1f} QPS; under the profiler {prof['device_ops']:.1f} device "
          f"ops/pass, idle share {prof['idle_share']:.4f}; K1 {launches['dense_scan_rowmax']}, "
          f"K2 {launches['dma_row_slices']}, K3 plain {launches['decode_rows']}, K3 scored "
          f"{launches['decode_score_rows']} launches in the checked pass, on {kind} ({smi})")
    return launches


def write_linedocs(path, num_docs, seed, first):
    """The first ``first`` docs of the ``num_docs``-doc ``bench_mix``
    corpus of ``seed`` as a luceneutil line-docs file
    (``title<TAB>date<TAB>body``); returns their token count."""
    from iresearch_tpu_torch import bench_mix

    buf, starts, ends = bench_mix.corpus_text(num_docs, seed)
    starts, ends = starts[:first].tolist(), ends[:first].tolist()
    with open(path, "wb") as f:
        for d, (s, e) in enumerate(zip(starts, ends)):
            f.write(b"doc%d\t2012-05-02\t%s\n" % (d, buf[s:e]))
    return sum((e + 1 - s) // 8 for s, e in zip(starts, ends))


def tee(fn, *args):
    """``fn(*args)`` with its standard output captured and echoed:
    (result, output)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        r = fn(*args)
    print(out.getvalue(), end="", flush=True)
    return r, out.getvalue()


CLI_DOCS = 1 << 18  # the first docs of phase 13's text that phase 14 puts
CLI_SEGMENT_DOCS = 1 << 17  # its flush threshold: two flushes, one merge


def run_cli(torch, num_docs, dev, smi, tmp):
    """Phase 14: the CLI and pyresearch on the card over the first
    ``CLI_DOCS`` docs of phase 13's text (``num_docs`` docs). Returns the
    launches of ``search --engine device``."""
    from iresearch_tpu_torch import bench_mix, pyresearch
    from iresearch_tpu_torch.cli import index_search
    from iresearch_tpu_torch.cli.__main__ import main as cli
    from iresearch_tpu_torch.exec import DeviceQuery
    from iresearch_tpu_torch.exec import batch as B
    from iresearch_tpu_torch.exec.executor import KERNELS
    from iresearch_tpu_torch.index.reader import DirectoryReader
    from iresearch_tpu_torch.kernels import build as kb
    from iresearch_tpu_torch.search import filters as F
    from iresearch_tpu_torch.search.host_eval import match_docs
    from iresearch_tpu_torch.search.scorers import get_scorer
    from iresearch_tpu_torch.store.directory import FSDirectory

    lines, idx = os.path.join(tmp, "lines.txt"), os.path.join(tmp, "index")
    t1 = time.perf_counter()
    ntok = write_linedocs(lines, num_docs, bench_mix.SEED + 1, CLI_DOCS)
    num_docs = min(num_docs, CLI_DOCS)
    print(f"cli: line-docs file of the first {num_docs} docs of phase 13's text, {ntok} "
          f"tokens (seed {bench_mix.SEED + 1}), {os.path.getsize(lines)} bytes in "
          f"{time.perf_counter() - t1:.3f} s")
    threads = 4
    put = ["put", "--in", lines, "--index-dir", idx, "--threads", str(threads),
           "--segment-docs-max", str(CLI_SEGMENT_DOCS), "--consolidate", "--invert", "auto",
           "--device", str(dev)]
    with scoped_clock() as calls:
        t1 = time.perf_counter()
        rc, _out = tee(cli, put)
        put_s = time.perf_counter() - t1
    if rc != 0:
        raise AssertionError(f"cli put: rc {rc}")
    flushes, inverts = [], []  # each flush inverts its 4 fields before it ends
    for n, t, _th in calls:
        if n == "writer.invert":
            inverts.append(t)
        elif n == "writer.flush":
            flushes.append((t, inverts))
            inverts = []
    merge_s = [t for n, t, _th in calls if n == "writer.consolidate_merge"]
    if len(flushes) != -(-num_docs // CLI_SEGMENT_DOCS) or inverts or any(
            len(inv) != 4 for _t, inv in flushes):
        raise AssertionError(f"flushes and their inversions on the card: {flushes}")
    print(f"cli put: {num_docs / put_s:.1f} docs/s ({put_s:.3f} s for {num_docs} docs: "
          f"{threads} indexer threads, an FSDirectory, --invert auto on {dev}, commit "
          f"and --consolidate included) on {smi}")
    for i, (fs, inv) in enumerate(flushes):
        print(f"  flush {i}: {fs:.3f} s, of it invert_device {sum(inv):.3f} s "
              f"(id, title, date, body: {', '.join(f'{t:.3f}' for t in inv)}) on {smi}")
    print(f"  consolidate: {sum(merge_s):.3f} s in {len(merge_s)} merges "
          f"(writer.consolidate_merge) on {smi}")
    reader = DirectoryReader.open(FSDirectory(idx))
    segs = list(reader.segments)
    if not merge_s or len(segs) != 1:
        raise AssertionError(f"--consolidate: {len(merge_s)} merges, {len(segs)} segments")
    if reader.docs_count != num_docs or reader.live_docs_count != num_docs:
        raise AssertionError(f"cli put wrote {reader.docs_count} docs")
    print(f"  index: {len(segs)} segments {[sr.num_docs for sr in segs]}, "
          f"{sum(os.path.getsize(os.path.join(idx, f)) for f in os.listdir(idx))} bytes")

    tasks_path = os.path.join(tmp, "tasks.txt")
    task_lines = bench_mix.task_lines(segs[0], 5)
    with open(tasks_path, "w") as f:
        f.write("\n".join(task_lines) + "\n")
    # what ``main`` computes, noted on its way out
    seen = []
    run_tasks = index_search.run_tasks

    def noting(*a):
        seen.append(run_tasks(*a))
        return seen[-1]

    search = ["search", "--in", tasks_path, "--index-dir", idx, "--topN", "10",
              "--max-tasks", "5", "--csv", "--device", str(dev)]
    index_search.run_tasks = noting
    B.clear_fused_cache()
    try:
        kb.reset_launch_counts()
        rc_d, _out = tee(cli, search + ["--engine", "device"])
        launches = kb.launch_counts()
        single = list(B._FUSED_KINDS["single"].values())
        rc_h, _out = tee(cli, search + ["--engine", "host"])
    finally:
        index_search.run_tasks = run_tasks
    if (rc_d, rc_h) != (0, 0) or len(seen) != 2:
        raise AssertionError(f"cli search: rc {rc_d} and {rc_h}")
    (dstats, dres), (hstats, hres) = seen
    if list(dres) != list(hres) or len(dres) != 110:
        raise AssertionError(f"{len(dres)} device tasks, {len(hres)} host tasks")
    for (cat, text), hits in dres.items():
        want = hres[(cat, text)]
        assert_gate(np.array([v for _d, v in hits], np.float32), np.array([d for d, _v in hits]),
                    np.array([d for d, _v in want]), np.array([v for _d, v in want]),
                    f"cli {cat} {text!r}")
    empty = sorted({cat for (cat, _t), hits in dres.items() if not hits})
    print(f"cli search: {len(dres)} tasks of {len(dstats)} categories, the device engine's "
          f"hits pass the exactness gate against the host engine's (categories without a "
          f"hit: {empty}); launches {launches}")
    for name in ("dense_scan_rowmax", "decode_score_rows"):
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} never launched by cli search")
    hits = sum(e.hits for e in single)
    print(f"cli search --engine device, fused by default: {len(single) + hits} single-query "
          f"calls over {len(dres)} tasks x {len(segs)} segments, {len(single)} misses "
          f"(a capture each), {hits} hits")

    # every wrapper call the device tasks made, again, recorded and held
    # against the kernels' plain versions; each task timed again eager and
    # fused (its entry made by the search above: a hit)
    scorer = get_scorer("bm25", {})
    rec = {name: [] for name in KERNELS._fields}
    again = {True: Counter(), False: Counter()}
    for cat, text in dres:
        dq = DeviceQuery(index_search.build_filter(cat, text, 16), segs, scorer, device=dev)
        for fused in (False, True):
            t1 = time.perf_counter()
            dq.top_k(10, fused=fused)
            again[fused][cat] += time.perf_counter() - t1
        for si in range(len(segs)):
            call = dq.single_call(si, 10)
            fn, args, kw = call.fn, call.args, call.kwargs
            for name, made in record_calls(KERNELS, fn, args, kw).items():
                rec[name].extend(made)
    print(f"per category, average us: device engine (fused, its misses included) / host "
          f"engine; the device tasks again: eager / fused (hits), on {smi}")
    for cat in sorted(dstats):
        (n, ds), (_n, hs) = dstats[cat], hstats[cat]
        print(f"  {cat}: {ds * 1e6 / n:.0f} / {hs * 1e6 / n:.0f}; "
              f"{again[False][cat] * 1e6 / n:.0f} / {again[True][cat] * 1e6 / n:.0f} ({n} tasks)")
    checked = check_recorded(torch, rec, "cli device tasks")
    # a miss launched its call's kernels twice, in the warm-up before its
    # capture and in its replay; every other launch is one replay of a call
    warm = sum((Counter(e.launches) for e in single), Counter())
    for name, n in launches.items():
        if n - warm[name] > checked[name]:
            raise AssertionError(f"kernel {name}: {n} launches by cli search ({warm[name]} "
                                 f"in the misses' warm-ups), {checked[name]} calls checked")

    r = subprocess.run(
        [sys.executable, "-m", "iresearch_tpu_torch.cli", "dump", "--index-dir", idx,
         "--max-terms", "5"], cwd=REPO, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", "")),
    )
    if r.returncode != 0 or f"{num_docs} docs ({num_docs} live)" not in r.stdout:
        raise AssertionError(f"cli dump: rc {r.returncode}\n{r.stdout[-2000:]}{r.stderr[-2000:]}")
    print("cli dump (a subprocess):\n" + "\n".join(r.stdout.splitlines()[:16]))
    pr = pyresearch.index_reader.open(idx)
    sr, fp = segs[0], segs[0].field("body")
    pf = next(iter(pr)).field("body")
    tid = int(np.argmax(fp.entries[:, 0]))
    term = sr.terms("body")[tid]
    it = pf.iterator()
    if pr.docs_count() != reader.docs_count or pf.terms_count() != fp.num_terms or not it.seek(term):
        raise AssertionError("pyresearch: docs, terms or the seek differ from the reader")
    docs = list(it.postings())
    if docs != match_docs(F.ByTerm("body", term), sr).tolist():
        raise AssertionError(f"pyresearch: postings of {term!r} differ from the reader")
    print(f"pyresearch: {pr.docs_count()} docs, {pf.terms_count()} body terms in segment 0, "
          f"the df-rank-0 term {term!r} with {len(docs)} docs through doc_iterator: equal to "
          f"the reader's")
    return launches


EMBED_DOCS = 120_000  # AG News' training docs
EMBED_LABELS = 4  # and its labels
EMBED_CHECK_DOCS = 2_000  # trained on the card and on the CPU
EMBED_INDEX_DOCS = 10_000  # written with the classification analyzer
EMBED_SEED = 45


def embed_corpus(num_docs, seed):
    """(texts, labels): the ``bench_mix`` corpus of ``seed`` as token
    lists; each vocabulary term from df rank 1,000 on but the last gets a
    seeded label, and a doc takes the label most of those tokens have (the
    lowest on a tie). The 1,000 commonest terms (85% of the tokens) and
    the last, which holds the clipped Zipf tail, carry no label, or one
    label would win almost every doc."""
    from iresearch_tpu_torch import bench_mix

    lens, tids = bench_mix.build_corpus(num_docs, seed)
    buf, starts, ends = bench_mix.corpus_text(num_docs, seed)
    texts = [buf[s:e].split() for s, e in zip(starts.tolist(), ends.tolist())]
    term_label = np.random.default_rng([seed, 1]).integers(0, EMBED_LABELS, bench_mix.VOCAB)
    doc = np.repeat(np.arange(num_docs), lens)
    tail = (tids >= 1000) & (tids < bench_mix.VOCAB - 1)  # the term id is its rank
    counts = np.bincount(doc[tail] * EMBED_LABELS + term_label[tids[tail]],
                         minlength=num_docs * EMBED_LABELS).reshape(num_docs, EMBED_LABELS)
    return texts, [b"__label__%d" % c for c in counts.argmax(axis=1)]


def run_embed(torch, num_docs, dev, smi, tmp):
    """Phase 15: ``train_supervised`` on the card at AG News' shape, held
    against the plain CPU run on the first docs; the model saved, loaded
    and served through a ``classification`` field."""
    from concurrent.futures import ThreadPoolExecutor

    from iresearch_tpu_torch import analysis
    from iresearch_tpu_torch.analysis import embed
    from iresearch_tpu_torch.exec import DeviceQuery
    from iresearch_tpu_torch.index.reader import DirectoryReader
    from iresearch_tpu_torch.index.writer import Field, IndexWriter, IndexWriterOptions
    from iresearch_tpu_torch.search import filters as F
    from iresearch_tpu_torch.store.directory import MemoryDirectory

    atol, rtol = 1e-5, 1e-4  # tests/test_torch_embed.py
    t1 = time.perf_counter()
    texts, labels = embed_corpus(num_docs, EMBED_SEED)
    print(f"embed corpus: {num_docs} docs, {sum(map(len, texts))} tokens, "
          f"{EMBED_LABELS} labels (seed {EMBED_SEED}) in {time.perf_counter() - t1:.3f} s")
    small = (texts[:EMBED_CHECK_DOCS], labels[:EMBED_CHECK_DOCS])
    with ThreadPoolExecutor(1) as pool:
        # the CPU's run takes minutes: it goes on beside the card's work
        cpu_run = pool.submit(embed.train_supervised, *small, device="cpu")
        card_small = embed.train_supervised(*small, device=dev)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        me = threading.get_ident()
        with scoped_clock() as calls:
            t1 = time.perf_counter()
            model = embed.train_supervised(texts, labels, device=dev)
            total_s = time.perf_counter() - t1
        peak = torch.cuda.max_memory_allocated(dev)
        rows_s = sum(t for n, t, th in calls if n == "embed.rows" and th == me)
        train_s = sum(t for n, t, th in calls if n == "embed.train" and th == me)
        epochs = len(model.losses)
        print(f"embed train_supervised on the card: {num_docs} docs, dim {model.dim}, "
              f"{epochs} epochs, {model.buckets} buckets, vocab {len(model.vocab)}: "
              f"{total_s:.3f} s, of it the host's row matrices {rows_s:.3f} s and the "
              f"training {train_s:.3f} s = {train_s / epochs:.5f} s per step (upload and "
              f"fetch included); peak device memory {peak} bytes ({peak - base} above "
              f"the {base} resident); loss {model.losses[0]:.6f} -> {model.losses[-1]:.6f}, "
              f"on {smi}")
        if not np.isfinite(model.losses).all() or not model.losses[-1] < model.losses[0]:
            raise AssertionError(f"the loss did not fall: {model.losses[[0, -1]]}")
        sample = np.random.default_rng(EMBED_SEED).choice(num_docs, 2_000, replace=False)
        hits = sum(model.predict(texts[i])[0][0] == labels[i] for i in sample)
        share = max(Counter(labels).values()) / num_docs
        print(f"  training accuracy on 2,000 sampled docs: {hits / 2_000:.4f} (chance "
              f"{1 / EMBED_LABELS}, the largest label's share {share:.4f})")
        if not hits / 2_000 > 1 / EMBED_LABELS:
            raise AssertionError("training accuracy at or below chance")
        cpu_small = cpu_run.result()
    for what, a, b in (("input", card_small.input_vectors, cpu_small.input_vectors),
                       ("label", card_small.label_vectors, cpu_small.label_vectors)):
        np.testing.assert_allclose(a, b, atol=atol, rtol=rtol, err_msg=f"{what} vectors")
    margin_docs = same = 0
    for t in small[0]:
        want = cpu_small.predict(t, k=2)
        if len(want) > 1 and want[0][1] - want[1][1] <= atol:
            continue
        margin_docs += 1
        same += card_small.predict(t)[0][0] == want[0][0]
    if same != margin_docs:
        raise AssertionError(f"top-1 predictions: {same} of {margin_docs} equal")
    err = float(np.abs(card_small.input_vectors - cpu_small.input_vectors).max())
    print(f"  the first {EMBED_CHECK_DOCS} docs trained on the card and on the CPU: vectors "
          f"within atol {atol} + rtol {rtol} (max abs difference {err:.3g}); top-1 "
          f"predictions equal on all {margin_docs} docs whose CPU margin exceeds {atol}")

    path = os.path.join(tmp, "embed.npz")
    model.save(path)
    back = embed.EmbeddingModel.load(path)
    if not (back.vocab == model.vocab and back.labels == model.labels
            and np.array_equal(back.input_vectors, model.input_vectors)
            and np.array_equal(back.label_vectors, model.label_vectors)):
        raise AssertionError("the model did not load back as saved")
    clf = analysis.get("classification", {"model_location": path})
    d = MemoryDirectory()
    t1 = time.perf_counter()
    with IndexWriter(d, IndexWriterOptions(), device=dev) as w:
        for t in texts[:EMBED_INDEX_DOCS]:
            w.insert([Field("label", b" ".join(t).decode(), analyzer=clf)])
        w.commit()
    write_s = time.perf_counter() - t1
    segs = list(DirectoryReader.open(d).segments)
    want = {}
    by_label = {}
    for i, t in enumerate(texts[:EMBED_INDEX_DOCS]):
        lbl = back.predict(t)[0][0]
        by_label.setdefault(lbl, []).append(i)
    for lbl in back.labels:
        docs = by_label.get(lbl, [])
        got = DeviceQuery(F.ByTerm("label", lbl.decode()), segs, device=dev).top_k(
            EMBED_INDEX_DOCS)
        if sorted(g for g, _v in got) != docs:
            raise AssertionError(f"ByTerm({lbl!r}): {len(got)} docs, predict gave {len(docs)}")
        want[lbl.decode()] = len(docs)
    print(f"  saved ({os.path.getsize(path)} bytes) and loaded back equal; a classification "
          f"field over {EMBED_INDEX_DOCS} docs written on the card in {write_s:.3f} s: "
          f"ByTerm on each label finds exactly the docs predict gave it {dict(want)}, on {smi}")


def run_multihost(smi):
    """Phase 16: the multi-process dryrun with both workers on the card.
    Returns the workers' launches, summed."""
    from iresearch_tpu_torch.parallel.multihost import dryrun_multihost

    t1 = time.perf_counter()
    outs = dryrun_multihost(num_processes=2, devices_per_proc=4, device="cuda")
    total = Counter()
    for pid, out in enumerate(outs):
        ok = re.search(rf"^MULTIHOST_OK process={pid}/2 .*$", out, re.M)
        m = re.search(rf"^MULTIHOST_LAUNCHES process={pid} (.*) tiers=(.*)$", out, re.M)
        if ok is None or m is None or "device=cuda:0" not in ok.group(0):
            raise AssertionError(f"multihost worker {pid}:\n{out[-2000:]}")
        launches = json.loads(m.group(1))
        g = re.search(rf"^MULTIHOST_FUSED process={pid} groups=(\d+) entries=(\d+) "
                      rf"shards=4 passes=(\d+) captured=(\d+) nodes=(\d+)$", out, re.M)
        if g is None or not int(g.group(1)) >= int(g.group(2)) > 0 \
                or not 4 * int(g.group(2)) == int(g.group(3)) == int(g.group(4)):
            raise AssertionError(f"multihost worker {pid}: its groups' graphs not captured on "
                                 f"each of its 4 shards:\n{out[-2000:]}")
        print(f"multihost worker {pid}: {ok.group(0)}; launches per replay {launches} in its "
              f"groups' tiers {m.group(2)}; {g.group(0)} (a graph per group on each of its "
              f"shards, the all_gather after the replays)")
        total.update(launches)
    print(f"multihost dryrun: 2 processes of 4 shards each, 1,536 docs in 8 segments, "
          f"{time.perf_counter() - t1:.3f} s, on {smi}")
    return {name: total[name] for name in launches}


BENCH_LINE_KEYS = ("metric", "value", "unit", "device", "power_limit_w", "failed")
BENCH_BUILD_DOCS = 20_000
BENCH_BUILD_THREADS = 4


def run_bench(torch, sr, dev, smi, kind):
    """Phase 18: the port's three benchmark entry points on the card.
    ``bench.run`` over the 5M-doc segment with ``bench.py``'s windows
    (its 25 oracle queries inside), ``bench_build.run`` at 20,000 docs with
    4 threads and ``bench_micro.run``; the launch counts are reset just
    before the first and read just after the last. Then every wrapper call
    of one batched pass of the bench is held against the plain versions
    (``check_calls``) and the micro table's decode row against K3's plain
    version. Returns the launches."""
    from iresearch_tpu_torch import bench, bench_build, bench_micro
    from iresearch_tpu_torch.formats.bitpack import pack_blocks
    from iresearch_tpu_torch.kernels import build as kb
    from iresearch_tpu_torch.ops import decode as dc

    def say(*a):
        print("bench:", *a, flush=True)

    kb.reset_launch_counts()
    t1 = time.perf_counter()
    res = bench.run([sr], device=dev, log=say)
    t2 = time.perf_counter()
    built = bench_build.run(BENCH_BUILD_DOCS, BENCH_BUILD_THREADS, device=dev, log=say)
    t3 = time.perf_counter()
    rows = bench_micro.run(device=dev)
    t4 = time.perf_counter()
    launches = kb.launch_counts()
    line = json.loads(json.dumps(res.line))
    missing = [key for key in BENCH_LINE_KEYS if key not in line]
    if missing or line["failed"] or line["device"] != kind or line["value"] <= 0:
        raise AssertionError(f"bench line: missing {missing}, {line}")
    print(f"bench line: {json.dumps(line)}")
    print(f"bench_build line: {json.dumps(built.line)}")
    print(f"bench_micro ({smi}):")
    width = max(len(n) for n, _t in rows)
    for name, t in rows:
        print(f"  {name:<{width}}  {t * 1e3:10.4f} ms")
    print(f"bench {t2 - t1:.3f} s, bench_build {t3 - t2:.3f} s, bench_micro {t4 - t3:.3f} s; "
          f"launches over the three {launches}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} never launched by the bench entry points")
    checked = check_calls(torch, res.prepared, "bench pass")
    print(f"bench pass, wrapper calls held against plain: {dict(checked)}")
    vals = np.random.default_rng(0).integers(0, 256, size=(4096, 128), dtype=np.uint64)
    args, kw = bench_micro.decode_args(pack_blocks(vals.astype(np.uint32), 8), dev)
    got, want = dc.decode_rows(*args, **kw), dc.decode_rows_ref(*args, **kw)
    torch.cuda.synchronize()
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        raise AssertionError("bench_micro's decode row: K3 differs from plain")
    print(f"bench_micro's decode row: K3 bit-exact against plain on {args[3].shape[0]} blocks")
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--docs", type=int, default=5_000_000)
    ap.add_argument("--profile", metavar="FILE",
                    help="also profile 5 batched passes; kernel table to FILE")
    ap.add_argument("--ingest-docs", type=int, default=1_250_000,
                    help="docs phase 13 writes (lower it only while debugging)")
    ap.add_argument("--kernel-times", action="store_true",
                    help="only hold the kernels against plain and time them "
                         "(phases 1-5 and the gather form of phase 8)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    from iresearch_tpu_torch import bench_mix
    from iresearch_tpu_torch.device import require_cuda
    from iresearch_tpu_torch.exec.batch import QueryBatch
    from iresearch_tpu_torch.index.segment import SegmentReader, device_state
    from iresearch_tpu_torch.kernels import build as kb
    from iresearch_tpu_torch.search.scorers import BM25

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

    cache_dir = os.path.join(REPO, ".bench_cache")
    t0 = time.perf_counter()
    data, cached = bench_mix.load_or_build(args.docs, cache_dir)
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
    floor = launch_floor(torch, dev)
    print(f"launch floor (an empty kernel, device time per launch): {floor} ms on {smi}")
    check_k1(torch, prep, kern, floor)
    check_k2_k3(torch, prep, kern, floor, smi)
    check_k4(torch, prep, kern, floor, smi)
    phase("5 kernels", t0)
    if args.kernel_times:
        check_gather(torch, tier_batch(sr, scorer, k, dev)[0], kern, floor, smi)
        print(json.dumps({"kernels": [dict(name=n, **r) for n, r in kern.items()]}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
        return 0

    t0 = time.perf_counter()
    prep = QueryBatch(filters, [sr], scorer, wand=True, device=dev).prepare(0, k)
    first, grouped, _entry, _stats = first_fused(torch, prep.run_grouped, "batch", prep._key,
                                                 "main path", smi)
    torch.cuda.synchronize()
    launches = kb.launch_counts()
    tiers = Counter(c[0] for c in prep.calls)
    tq = Counter()
    for t, qis, *_r in prep.calls:
        tq[t] += len(qis)
    print(f"groups per tier: {dict(tiers)}; queries per tier: {dict(tq)}")
    print(f"launches in the main-path run: {launches}")
    # K3's plain form is on the tier batch's path (the join's probe, phase 8)
    for name, n in launches.items():
        if n <= 0 and name != "decode_rows":
            raise AssertionError(f"kernel {name} never launched on the main path")
    if set(tiers) != {"skyline", "dslice", "scan"}:
        raise AssertionError(f"tiers {dict(tiers)}: expected all three")
    strip = lambda g: [pair for pair, _q in g]  # noqa: E731
    # the one-segment mix has no fold group: every score is bit-stable
    same_results(torch, strip(first), strip(grouped), "main path: first and second fused run",
                 exact=True)
    same_results(torch, strip(grouped), strip(prep.run_grouped(fused=False)),
                 "main path: fused and eager", exact=True)
    plain = prep.run_grouped(plain=True)
    same_results(torch, strip(grouped), strip(plain), "main path: fused and plain", exact=True)
    vals, docs = per_query(grouped, len(tasks))
    pvals, pdocs = per_query(plain, len(tasks))
    for qi in range(len(tasks)):
        np.testing.assert_array_equal(docs[qi], pdocs[qi])
        np.testing.assert_allclose(vals[qi], pvals[qi], rtol=1e-5, atol=0.0)
    print(f"main path: the fused pass equals the eager pass and the plain-torch run bit for "
          f"bit on all {len(tasks)} queries")
    check_oracle(vals, docs, tasks, sr, scorer, k)
    phase("6 main path", t0)

    t0 = time.perf_counter()
    both_ways(torch, prep.run_grouped, len(tasks), "batched passes", smi, kind)
    if args.profile:
        for fused in (True, False):
            profile_passes(torch, lambda: prep.run_grouped(fused=fused),
                           f"{args.profile}.one.{'fused' if fused else 'eager'}", kind, smi)
    phase("7 timing", t0)

    t0 = time.perf_counter()
    run_breadth(torch, sr, scorer, k, dev, smi)
    tier_prep, tier_tasks = tier_batch(sr, scorer, k, dev)
    tier_launches = run_tiers(torch, tier_prep, tier_tasks, sr, scorer, k, smi)
    print(f"launches over the {len(tier_tasks)} tier calls: {dict(tier_launches)}")
    tier_first, tier_second, _entry, _stats = first_fused(
        torch, tier_prep.run_grouped, "batch", tier_prep._key, "tier batch", smi)
    for got, what in ((tier_first, "first"), (tier_second, "second")):
        same_results(torch, strip(got), strip(tier_prep.run_grouped(fused=False)),
                     f"tier batch: {what} fused run and eager")
    print("tier batch: every tier's group captured and replayed in one graph")
    check_gather(torch, tier_prep, kern, floor, smi)
    single_launches = run_single_tiers(torch, sr, scorer, k, dev, smi)
    print(f"launches over one replay of each tier's single query: {dict(single_launches)}")
    phase("8 breadth and tiers", t0)

    t0 = time.perf_counter()
    phrase_launches = run_phrases(torch, sr, scorer, k, dev, smi, kern, floor)
    print(f"launches over the phrase queries' first runs: {dict(phrase_launches)}")
    phase("9 phrase", t0)

    t0 = time.perf_counter()
    # bench.py's segment law (segment si has seed 42 + si), sizes as tiered
    # consolidation leaves them
    seg_sizes = [args.docs, max(2_000, args.docs // 4), 1_000]
    srs = [sr]
    for si, n in enumerate(seg_sizes[1:], start=1):
        d, was_cached = bench_mix.load_or_build(n, cache_dir, si)
        srs.append(SegmentReader(f"smoke{si}", d))
        srs[-1].dense_cache("body")
        print(f"segment {si}: {n} docs, {'loaded' if was_cached else 'built'}")
    print(f"index segments ready in {time.perf_counter() - t0:.3f} s")
    index_launches, merged = run_index(torch, srs, tasks, scorer, k, dev, smi, kind,
                                       args.profile)
    run_serving(torch, srs, tasks, scorer, k, dev, smi, kind)
    phase("10 index", t0)

    t0 = time.perf_counter()
    run_invert(torch, seg_sizes[1], bench_mix.SEED + 1, dev, smi)
    phase("11 invert", t0)

    t0 = time.perf_counter()
    sharded_launches, one_shard = run_sharded(torch, srs, tasks, scorer, k, dev, smi, kind,
                                              args.profile, merged)
    phase("12 sharded", t0)

    t0 = time.perf_counter()
    # phase 10's segment of seed 43 when it has the same size, else built
    want = (srs[1].data if seg_sizes[1] == args.ingest_docs
            else bench_mix.load_or_build(args.ingest_docs, cache_dir, 1)[0])
    ingested, removed = run_ingest(torch, args.ingest_docs, want, dev, smi)
    ingest_launches = serve_ingested(torch, ingested, removed, scorer, k, dev, smi, kind)
    phase("13 ingest", t0)

    os.makedirs(cache_dir, exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="smoke_", dir=cache_dir) as tmp:
        t0 = time.perf_counter()
        cli_launches = run_cli(torch, args.ingest_docs, dev, smi, tmp)
        phase("14 cli", t0)

        t0 = time.perf_counter()
        run_embed(torch, EMBED_DOCS, dev, smi, tmp)
        phase("15 embed", t0)

    t0 = time.perf_counter()
    multihost_launches = run_multihost(smi)
    phase("16 multihost", t0)

    t0 = time.perf_counter()
    mesh_launches, mesh_pass, mesh_out = run_mesh(torch, srs, tasks, scorer, k, smi, kind,
                                                  merged, one_shard, args.profile)
    phase("17 mesh", t0)

    t0 = time.perf_counter()
    paths = [bench_mix.segment_path(n, cache_dir, si) for si, n in enumerate(seg_sizes)]
    nccl_launches = run_nccl(torch, srs, paths, tasks, scorer, k, smi, kind, mesh_pass,
                             mesh_out, one_shard)
    phase("19 nccl", t0)

    t0 = time.perf_counter()
    bench_launches = run_bench(torch, sr, dev, smi, kind)
    phase("18 bench", t0)
    if args.profile:
        profile_passes(torch, prep.run_grouped, args.profile, kind, smi, prep.calls)
        profile_tiers(torch, tier_prep, smi)

    # the port and this script import nothing of JAX or of the JAX
    # package, even where they are installed
    jax_mods = sorted(m for m in sys.modules
                      if m.split(".")[0] in ("jax", "iresearch_tpu"))
    if jax_mods:
        raise AssertionError(f"JAX modules imported: {jax_mods[:5]}")
    print("imports: no module of jax or iresearch_tpu loaded")

    counts = dict(launches_pass=launches, launches_tiers=tier_launches,
                  launches_single=single_launches, launches_phrase=phrase_launches, launches_index=index_launches,
                  launches_sharded=sharded_launches, launches_ingest=ingest_launches,
                  launches_cli=cli_launches, launches_multihost=multihost_launches,
                  launches_mesh=mesh_launches, launches_nccl=nccl_launches,
                  launches_bench=bench_launches)
    for name in kb.KERNELS:
        if sum(c[name] for c in counts.values()) <= 0:
            raise AssertionError(f"kernel {name} never launched on a main path")
    print(json.dumps({"kernels": [
        dict(name=name, route="cuda", source=SOURCES.get(name, SOURCE), replaces=REPLACES[name],
             launches=sum(c[name] for c in counts.values()),
             **{key: c[name] for key, c in counts.items()}, **kern[name])
        for name in kb.KERNELS
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
