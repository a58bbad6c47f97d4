"""Multi-process dryrun of the sharded searcher (``iresearch_tpu/parallel/
multihost.py``).

The JAX package proves its process-spanning mesh with N local processes
that join one ``jax.distributed`` cluster (gloo CPU collectives standing in
for DCN), each process with ``devices_per_proc`` devices. Here the
processes join one ``torch.distributed`` group over gloo (``tcp://`` at a
coordinator address; NCCL would take one rank per card), and each holds
``devices_per_proc`` shards in a ``ShardedSearcher``, one per device of
its mesh: ``devices_per_proc`` distinct cards where the host has
``num_processes * devices_per_proc`` of them (process ``i`` takes cards
``i * K .. i * K + K - 1``), else ``devices_per_proc`` shards on
``device``. Each process builds the same corpus of ``num_processes *
devices_per_proc`` segments with the port's writer, one segment a shard,
runs the same batched search, and the candidates meet on its first device
and then in the searcher's ``all_gather``; every process checks the global
top-k against the host oracle.

Run a worker:

    python -m iresearch_tpu_torch.parallel.multihost --process-id I \
        --num-processes N --coordinator localhost:PORT \
        --devices-per-proc K [--device cpu]

or drive the whole group via ``dryrun_multihost()``
(``tests/test_torch_multihost.py``, ``chip_smoke.py`` phase 16).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


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


def mesh_devices(process_id: int, num_processes: int, devices_per_proc: int,
                 device=None):
    """Process ``process_id``'s ``devices_per_proc`` mesh devices: where
    ``device`` names no card of its own (None or ``"cuda"``) and the host
    has ``num_processes * K`` cards, the distinct cards ``process_id * K
    ..``, as each JAX process has K devices; else ``device`` (the card
    when None) K times."""
    import torch

    from iresearch_tpu_torch.exec.executor import entry_device

    K = devices_per_proc
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
) -> None:
    """One process of the dryrun group.

    Joins the gloo group at ``coordinator``, builds the shared corpus of
    ``num_processes * devices_per_proc`` segments, holds its share of them
    in ``devices_per_proc`` shards (``mesh_devices``; on the card when
    ``device`` is None) and runs the batched sharded search, asserting
    exact oracle parity (every process gets the global top-k)."""
    import torch.distributed as dist

    devices = mesh_devices(process_id, num_processes, devices_per_proc, device)
    dist.init_process_group(
        "gloo",
        init_method="tcp://" + coordinator,
        world_size=num_processes,
        rank=process_id,
    )
    try:
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
        loaded = sorted(
            m for m in sys.modules if m.split(".")[0] in ("jax", "iresearch_tpu")
        )
        if loaded:
            raise AssertionError(f"JAX modules imported: {loaded[:5]}")
        # keep stdout greppable by the launcher
        print(f"MULTIHOST_HITS process={process_id} {json.dumps(got)}", flush=True)
        tiers = sorted({c[0] for c in prep.calls})
        print(f"MULTIHOST_LAUNCHES process={process_id} {json.dumps(launches)} "
              f"tiers={','.join(tiers)}", flush=True)
        from iresearch_tpu_torch.exec.batch import _FUSED_KINDS

        # top_k replays one graph of this process's part per signature
        # group and shard; the gather onto its first device, the all_gather
        # and the re-rank follow them: an entry of the "sharded" LRU per
        # group replays one graph on each of this process's shards
        entries = _FUSED_KINDS["sharded"].values()
        passes = [p for e in entries for p in e.passes]
        print(f"MULTIHOST_FUSED process={process_id} groups={len(prep.groups)} "
              f"entries={len(entries)} shards={len(devices)} passes={len(passes)} "
              f"captured={sum(p.graph is not None for p in passes)} "
              f"nodes={sum(p.nodes for p in passes)}", flush=True)
        print(f"MULTIHOST_OK process={process_id}/{num_processes} "
              f"devices={n_global} queries={len(qs)} device={devices[0]} "
              f"mesh={','.join(map(str, devices))}", flush=True)
    finally:
        dist.destroy_process_group()


def dryrun_multihost(
    num_processes: int = 2,
    devices_per_proc: int = 4,
    timeout: int = 600,
    device=None,
):
    """Spawn the worker group and require every process to pass; returns
    each worker's output. ``device`` is passed to every worker (the card
    when None; ``mesh_devices`` gives each its shards' devices)."""
    import socket

    with socket.socket() as s:  # free localhost port for the coordinator
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    coordinator = f"localhost:{port}"
    path = os.environ.get("PYTHONPATH")
    env = dict(os.environ, PYTHONPATH=_REPO + (os.pathsep + path if path else ""))
    procs = []
    logs = []
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
            "--devices-per-proc", str(devices_per_proc),
        ]
        if device is not None:
            cmd += ["--device", str(device)]
        procs.append(
            subprocess.Popen(
                cmd, stdout=log, stderr=subprocess.STDOUT, env=env, cwd=_REPO
            )
        )
    try:
        for p in procs:
            p.wait(timeout=timeout)
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
    print(
        f"dryrun_multihost OK: {num_processes} processes x "
        f"{devices_per_proc} shards, exact oracle parity in every process"
    )
    return outs


def _main() -> None:
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--devices-per-proc", type=int, default=4,
                    help="shards of each process: distinct cards where the host has "
                         "enough, else shards on --device")
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    a = ap.parse_args()
    run_worker(
        a.process_id, a.num_processes, a.coordinator, a.devices_per_proc,
        device=a.device,
    )


if __name__ == "__main__":
    _main()
