"""Multi-process dryrun of the sharded searcher (``iresearch_tpu/parallel/
multihost.py``).

The JAX package proves its process-spanning mesh with N local processes
that join one ``jax.distributed`` cluster (gloo CPU collectives standing in
for DCN), each process with ``devices_per_proc`` devices. Here the
processes join one ``torch.distributed`` group at a coordinator address
(``tcp://``), over a backend per worker:

* ``gloo`` (the default; processes that share a card or run on the CPU):
  each holds ``devices_per_proc`` shards in a ``ShardedSearcher``, one per
  device of its mesh: ``devices_per_proc`` distinct cards where the host
  has ``num_processes * devices_per_proc`` of them (process ``i`` takes
  cards ``i * K .. i * K + K - 1``), else ``devices_per_proc`` shards on
  ``device``; the candidates meet on its first device after the replays
  and then in the searcher's ``all_gather``, staged on the host;
* ``nccl`` (one process per card, as NCCL requires): process ``i`` takes
  card ``i`` and holds its ``devices_per_proc`` shards there; each
  signature group is one CUDA graph per process holding the all_gather
  and the re-rank, so a replay makes no call into ``torch.distributed``.

Each process builds the same corpus of ``num_processes *
devices_per_proc`` segments with the port's writer, one segment a shard,
runs the same batched search, and checks the global top-k against the host
oracle; then it runs it again under ``dist_calls`` and prints where the
join ran, its graphs per group and its calls into ``torch.distributed``.
With ``--segments`` the processes instead open the same segment files
(``write_segment`` bytes, as ``index/segment.py:carry_segment`` reads
them), serve the bench mix over them and write their result for the
launcher to compare (``serve_multihost``).

Run a worker:

    python -m iresearch_tpu_torch.parallel.multihost --process-id I \
        --num-processes N --coordinator localhost:PORT \
        --devices-per-proc K [--device cpu] [--backend gloo|nccl] \
        [--segments A.bin,B.bin,... --out DIR]

or drive the whole group via ``dryrun_multihost()``
(``tests/test_torch_multihost.py``, ``chip_smoke.py`` phase 16) or
``serve_multihost()`` (``chip_smoke.py`` phase 19).
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import subprocess
import sys
import tempfile
import time
import types
from collections import Counter

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SERVE_PASSES = 1  # timed passes each way and turn of ``_serve_index``


def _build_reader(num_docs: int, segments: int):
    """Deterministic corpus — every process builds identical segments
    (the multi-host analog of every host opening the same on-disk
    index generation; reference: directory_reader snapshot open)."""
    import numpy as np

    from iresearch_tpu_torch.index.reader import DirectoryReader
    from iresearch_tpu_torch.index.writer import (
        Field,
        IndexWriter,
        IndexWriterOptions,
    )
    from iresearch_tpu_torch.store.directory import MemoryDirectory

    words = [
        "alpha", "beta", "gamma", "delta", "epsilon", "zeta", "eta",
        "theta", "iota", "kappa", "lam", "mu", "nu", "xi", "omicron", "pi",
    ]
    rng = np.random.default_rng(7)
    d = MemoryDirectory()
    per_seg = max(1, num_docs // segments)
    with IndexWriter(d, IndexWriterOptions(invert_backend="numpy")) as w:
        for i in range(num_docs):
            n = int(rng.integers(3, 24))
            idx = np.minimum(rng.zipf(1.5, size=n) - 1, len(words) - 1)
            w.insert(
                [
                    Field(
                        "body",
                        " ".join(words[j] for j in idx),
                        analyzer="segmentation",
                    )
                ]
            )
            if (i + 1) % per_seg == 0 and segments > 1:
                w.commit()
        w.commit()
    return DirectoryReader.open(d)


def queries():
    """The dryrun's four queries (the port's filters)."""
    from iresearch_tpu_torch.search import filters as F

    return [
        F.ByTerm("body", "alpha"),
        F.Or(
            *[F.ByTerm("body", w) for w in ("alpha", "beta", "gamma", "delta")]
        ),
        F.Or(
            F.ByTerm("body", "alpha"),
            F.ByTerm("body", "beta"),
            F.ByTerm("body", "gamma"),
            min_match=2,
        ),
        F.And(F.ByTerm("body", "alpha"), F.ByTerm("body", "beta")),
    ]


@contextlib.contextmanager
def dist_calls():
    """A ``Counter`` (by name) of the calls into ``torch.distributed``'s
    public functions made through the module inside the block: every
    function attribute of ``torch.distributed`` is wrapped for its
    duration (calls inside ``torch.distributed`` itself are not counted)."""
    import torch.distributed as dist

    calls = Counter()
    saved = {name: fn for name, fn in vars(dist).items()
             if not name.startswith("_") and type(fn) is types.FunctionType}

    def counted(name, fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)

        return call

    for name, fn in saved.items():
        setattr(dist, name, counted(name, fn))
    try:
        yield calls
    finally:
        for name, fn in saved.items():
            setattr(dist, name, fn)


def mesh_devices(process_id: int, num_processes: int, devices_per_proc: int,
                 device=None, backend: str = "gloo"):
    """Process ``process_id``'s ``devices_per_proc`` mesh devices. On
    ``gloo``: where ``device`` names no card of its own (None or
    ``"cuda"``) and the host has ``num_processes * K`` cards, the distinct
    cards ``process_id * K ..``, as each JAX process has K devices; else
    ``device`` (the card when None) K times. On ``nccl``: K times the
    process's own card, card ``process_id`` (``device`` may name it only
    for a group of one process); raises where the processes would share
    one."""
    import torch

    from iresearch_tpu_torch.exec.executor import entry_device

    K = devices_per_proc
    if backend == "nccl":
        if device is not None and str(device) != "cuda":
            card = entry_device(device)
            if num_processes > 1 or card.type != "cuda":
                raise ValueError(
                    f"an NCCL group puts each process on a card of its own: --device {device} "
                    f"for {num_processes} process(es); use the gloo backend to share a card")
        elif torch.cuda.device_count() < num_processes:
            raise ValueError(
                f"an NCCL group of {num_processes} processes needs {num_processes} cards, "
                f"{torch.cuda.device_count()} visible; use the gloo backend to share a card")
        else:
            card = torch.device("cuda", process_id)
        return [card] * K
    if (device is None or str(device) == "cuda") and torch.cuda.is_available() \
            and torch.cuda.device_count() >= num_processes * K:
        return [torch.device("cuda", process_id * K + j) for j in range(K)]
    return [entry_device(device)] * K


def run_worker(
    process_id: int,
    num_processes: int,
    coordinator: str,
    devices_per_proc: int,
    device=None,
    backend: str = "gloo",
    segments=None,
    out=None,
) -> None:
    """One process of the group.

    Joins the ``backend`` group at ``coordinator`` (NCCL's communicator
    made at once on the process's card), holds its share of the segments
    in ``devices_per_proc`` shards (``mesh_devices``; on the card when
    ``device`` is None) and runs ``_dryrun`` over the shared corpus, or
    with ``segments`` (segment file paths) ``_serve_index``, which writes
    its result under ``out``."""
    import torch
    import torch.distributed as dist

    devices = mesh_devices(process_id, num_processes, devices_per_proc, device, backend)
    kw = {}
    if backend == "nccl":
        torch.cuda.set_device(devices[0])
        kw["device_id"] = devices[0]
    dist.init_process_group(
        backend,
        init_method="tcp://" + coordinator,
        world_size=num_processes,
        rank=process_id,
        **kw,
    )
    try:
        if segments:
            _serve_index(process_id, num_processes, devices, segments, out)
        else:
            _dryrun(process_id, num_processes, devices_per_proc, devices)
        loaded = sorted(
            m for m in sys.modules if m.split(".")[0] in ("jax", "iresearch_tpu")
        )
        if loaded:
            raise AssertionError(f"JAX modules imported: {loaded[:5]}")
    finally:
        from iresearch_tpu_torch.exec.batch import clear_fused_cache

        clear_fused_cache()  # no graph may outlive the communicator it holds
        dist.destroy_process_group()


def _join_line(process_id: int, searcher, prep, calls) -> str:
    """Where ``prep``'s joins ran, its graphs per signature group and the
    calls into ``torch.distributed`` of its replays (``calls``); on an
    NCCL mesh raises unless they made none."""
    import torch.distributed as dist

    from iresearch_tpu_torch.exec.batch import _FUSED_KINDS

    mesh = searcher.mesh
    per_group = sorted({len(e.passes) for e in _FUSED_KINDS["sharded"].values()})
    n = sum(calls.values())
    if mesh.join_in_graph and n:
        raise AssertionError(f"the replays of an NCCL mesh called torch.distributed: {dict(calls)}")
    backend = mesh.group and dist.get_backend(mesh.group)
    return (f"MULTIHOST_JOIN process={process_id} backend={backend} "
            f"join={'graph' if mesh.join_in_graph else 'host'} groups={len(prep.groups)} "
            f"graphs_per_group={','.join(map(str, per_group))} dist_calls={n} {json.dumps(calls)}")


def _dryrun(process_id, num_processes, devices_per_proc, devices) -> None:
    """The JAX dryrun's corpus and four queries over this process's
    shards, exact oracle parity asserted (every process gets the global
    top-k), then the same batch again with its calls into
    ``torch.distributed`` counted."""
    from iresearch_tpu_torch.exec.batch import _FUSED_KINDS
    from iresearch_tpu_torch.kernels import build as kb
    from iresearch_tpu_torch.parallel import ShardedSearcher
    from iresearch_tpu_torch.search.host_eval import search as host_search
    from iresearch_tpu_torch.search.scorers import BM25

    n_global = num_processes * devices_per_proc
    reader = _build_reader(num_docs=192 * n_global, segments=n_global)
    searcher = ShardedSearcher(list(reader.segments), devices=devices)
    if (searcher.mesh.world, searcher.D, searcher.per_shard) != (num_processes, n_global, 1):
        raise AssertionError(f"mesh {searcher.mesh}, {searcher.per_shard} segments a shard")
    qs = queries()
    kb.reset_launch_counts()
    prep = searcher.prepare_many(qs, BM25(), wand=True)
    got = prep.top_k(5)
    launches = kb.launch_counts()
    for q, hits in zip(qs, got):
        want = host_search(reader, q, k=5)
        if [h[0] for h in hits] != [e[0] for e in want] or any(
            abs(gv - wv) > 1e-5 * max(1.0, abs(wv))
            for (_gd, gv), (_wd, wv) in zip(hits, want)
        ):
            raise AssertionError(f"{q}: {hits} against the oracle's {want}")
    with dist_calls() as calls:
        again = prep.top_k(5)
    if again != got:
        raise AssertionError(f"the replayed batch gave {again}, the first {got}")
    # keep stdout greppable by the launcher
    print(f"MULTIHOST_HITS process={process_id} {json.dumps(got)}", flush=True)
    tiers = sorted({c[0] for c in prep.calls})
    print(f"MULTIHOST_LAUNCHES process={process_id} {json.dumps(launches)} "
          f"tiers={','.join(tiers)}", flush=True)
    # top_k replays per signature group one graph of this process's part
    # on each of its shards (gloo: the joins follow the replays) or one
    # graph of the whole group body (NCCL: the all_gather inside it)
    entries = _FUSED_KINDS["sharded"].values()
    passes = [p for e in entries for p in e.passes]
    print(f"MULTIHOST_FUSED process={process_id} groups={len(prep.groups)} "
          f"entries={len(entries)} shards={len(devices)} passes={len(passes)} "
          f"captured={sum(p.graph is not None for p in passes)} "
          f"nodes={sum(p.nodes for p in passes)}", flush=True)
    print(_join_line(process_id, searcher, prep, calls), flush=True)
    print(f"MULTIHOST_OK process={process_id}/{num_processes} "
          f"devices={n_global} queries={len(qs)} device={devices[0]} "
          f"mesh={','.join(map(str, devices))}", flush=True)


def _serve_index(process_id, num_processes, devices, paths, out) -> None:
    """The bench mix (``bench_mix.task_mix`` of the first segment) over the
    segment files ``paths``, sharded over this process's ``devices`` in the
    group: the first pass (the captures) and a second under
    ``dist_calls`` (on an NCCL mesh replays with no call into
    ``torch.distributed``), equal; then ``SERVE_PASSES`` synchronised
    passes each way in turns (fused, eager, eager, fused), the device's
    busy share of ``SERVE_PASSES`` fused passes (torch.profiler; also without NCCL's
    kernels, which wait for the other ranks), and the result, written to
    ``out/result{process_id}.npy`` as [2, Q, k] int32 (the scores' bits,
    the docs)."""
    import numpy as np
    import torch

    from iresearch_tpu_torch import bench_mix
    from iresearch_tpu_torch.index.segment import carry_segment
    from iresearch_tpu_torch.kernels import build as kb
    from iresearch_tpu_torch.parallel import ShardedSearcher
    from iresearch_tpu_torch.search.scorers import BM25

    t0 = time.perf_counter()
    srs = []
    for i, path in enumerate(paths):
        with open(path, "rb") as f:
            srs.append(carry_segment(f"seg{i}", f.read()))
    filters = [f for _c, f in bench_mix.task_mix(srs[0])]
    k = bench_mix.K
    searcher = ShardedSearcher(srs, devices=devices)
    prep = searcher.prepare_many(filters, BM25(), wand=True, k_max=k)
    open_s = time.perf_counter() - t0

    def packed(res):
        vals = torch.stack([v for v, _d in res])
        docs = torch.stack([d for _v, d in res])
        return torch.stack([vals.view(torch.int32), docs]).cpu().numpy()

    def sync():
        for d in {d for d in devices if d.type == "cuda"}:
            torch.cuda.synchronize(d)

    passes = SERVE_PASSES
    t1 = time.perf_counter()
    first = packed(prep.run(k))
    first_s = time.perf_counter() - t1
    kb.reset_launch_counts()
    with dist_calls() as calls:
        second = prep.run(k)
        sync()
    launches = kb.launch_counts()
    if not np.array_equal(packed(second), first):
        raise AssertionError("the second (replayed) pass differs from the first")
    eager = packed(prep.run(k, fused=False))
    if not np.array_equal(eager[1], first[1]):
        raise AssertionError("the eager pass's docs differ from the fused pass's")

    def pass_ms(fused):
        prep.run(k, fused=fused)
        sync()
        t = time.perf_counter()
        for _ in range(passes):
            prep.run(k, fused=fused)
        sync()
        return (time.perf_counter() - t) * 1e3 / passes

    ms = {True: [], False: []}
    for fused in (True, False, False, True):
        ms[fused].append(round(pass_ms(fused), 4))
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(passes):
            prep.run(k)
        sync()
        wall = time.perf_counter() - t
    kernels = [e for e in prof.events() if e.device_type.name == "CUDA"]
    busy = sum(e.device_time_total for e in kernels) / 1e6
    nccl = sum(e.device_time_total for e in kernels if "nccl" in e.name.lower()) / 1e6
    os.makedirs(out, exist_ok=True)
    np.save(os.path.join(out, f"result{process_id}.npy"), first)
    print(_join_line(process_id, searcher, prep, calls), flush=True)
    print(f"MULTIHOST_INDEX process={process_id} card={devices[0]} shards={len(devices)} "
          f"segments={[segs for _g, _d, segs in searcher.shards]} docs={searcher.total_docs} "
          f"queries={len(filters)} open_s={open_s:.3f} first_s={first_s:.3f} "
          f"fused_ms={ms[True]} eager_ms={ms[False]} profiled_ms={wall / passes * 1e3:.4f} "
          f"idle={1 - busy / wall:.4f} idle_outside_nccl={1 - (busy - nccl) / wall:.4f} "
          f"launches={json.dumps(launches)}", flush=True)
    print(f"MULTIHOST_OK process={process_id}/{num_processes} device={devices[0]}", flush=True)


def _spawn(num_processes: int, args, timeout: int):
    """Run ``num_processes`` workers with the worker arguments ``args``
    (a coordinator at a free localhost port), require every one to exit 0
    and print ``MULTIHOST_OK``; returns each worker's output. A worker
    still running at ``timeout`` seconds is killed and fails, and every
    worker is stopped before this returns or raises."""
    import socket

    with socket.socket() as s:  # free localhost port for the coordinator
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    coordinator = f"localhost:{port}"
    path = os.environ.get("PYTHONPATH")
    env = dict(os.environ, PYTHONPATH=_REPO + (os.pathsep + path if path else ""))
    procs = []
    logs = []
    try:
        for pid in range(num_processes):
            log = tempfile.NamedTemporaryFile(
                mode="w+", suffix=f".mh{pid}.log", delete=False
            )
            logs.append(log)
            cmd = [
                sys.executable,
                "-m",
                "iresearch_tpu_torch.parallel.multihost",
                "--process-id", str(pid),
                "--num-processes", str(num_processes),
                "--coordinator", coordinator,
            ] + list(args)
            procs.append(
                subprocess.Popen(
                    cmd, stdout=log, stderr=subprocess.STDOUT, env=env, cwd=_REPO
                )
            )
        deadline = time.monotonic() + timeout
        for p in procs:
            with contextlib.suppress(subprocess.TimeoutExpired):
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    outs = []
    for log in logs:
        log.seek(0)
        outs.append(log.read())
        log.close()
        os.unlink(log.name)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0 or "MULTIHOST_OK" not in out:
            raise RuntimeError(
                f"multihost worker {pid} failed (rc={p.returncode}):\n"
                + out[-4000:]
            )
    return outs


def dryrun_multihost(
    num_processes: int = 2,
    devices_per_proc: int = 4,
    timeout: int = 600,
    device=None,
    backend: str = "gloo",
):
    """Spawn the worker group and require every process to pass; returns
    each worker's output. ``device`` is passed to every worker (the card
    when None; ``mesh_devices`` gives each its shards' devices);
    ``backend``: ``"gloo"`` or ``"nccl"`` (a card of its own per
    process)."""
    args = ["--devices-per-proc", str(devices_per_proc), "--backend", backend]
    if device is not None:
        args += ["--device", str(device)]
    outs = _spawn(num_processes, args, timeout)
    print(
        f"dryrun_multihost OK: {num_processes} processes x "
        f"{devices_per_proc} shards over {backend}, exact oracle parity in every process"
    )
    return outs


def serve_multihost(paths, num_processes: int, out: str, timeout: int = 900):
    """Spawn an NCCL group of ``num_processes`` workers, one per card with
    one shard there, over the segment files ``paths`` (each worker opens
    every file; its shard's segments go onto its card), each serving the
    bench mix (``_serve_index``); returns (each worker's output, each
    worker's result [2, Q, k] int32 read from ``out``)."""
    import numpy as np

    args = ["--devices-per-proc", "1", "--backend", "nccl",
            "--segments", ",".join(paths), "--out", out]
    outs = _spawn(num_processes, args, timeout)
    return outs, [np.load(os.path.join(out, f"result{pid}.npy")) for pid in range(num_processes)]


def _main() -> None:
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--devices-per-proc", type=int, default=4,
                    help="shards of each process: on gloo distinct cards where the host has "
                         "enough, else shards on --device; on nccl shards on its own card")
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    ap.add_argument("--backend", default="gloo", choices=["gloo", "nccl"],
                    help="the group's backend: nccl needs a card of its own per process")
    ap.add_argument("--segments", default=None,
                    help="comma-separated segment files to serve the bench mix over")
    ap.add_argument("--out", default=None, help="directory of the --segments run's results")
    a = ap.parse_args()
    run_worker(
        a.process_id, a.num_processes, a.coordinator, a.devices_per_proc,
        device=a.device, backend=a.backend,
        segments=a.segments.split(",") if a.segments else None, out=a.out,
    )


if __name__ == "__main__":
    _main()
