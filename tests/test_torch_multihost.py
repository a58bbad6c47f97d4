"""The port's multi-process dryrun (``iresearch_tpu_torch/parallel/
multihost.py``) on the CPU.

Two worker processes join one gloo group, each holds two of the four
segments of the JAX dryrun's corpus in a ``ShardedSearcher`` of two
shards, one segment each, and runs the four queries; each checks its
global top-5 against the port's host oracle and prints it. Here every
worker's hits are also held against the JAX package's ``host_eval.search``
and its ``ShardedSearcher`` over four devices on the JAX-built copy of the
same corpus.
The same dryrun with both workers on one card is marked ``cuda``.
"""

import json
import re

import pytest

torch = pytest.importorskip("torch")

from iresearch_tpu_torch.parallel.multihost import dryrun_multihost  # noqa: E402
from test_torch_carry import to_jax  # noqa: E402
from topk_util import assert_topk_equiv  # noqa: E402


def _hits(outs):
    """Each worker's printed hits: [[(doc, score), ...] per query]."""
    got = []
    for pid, out in enumerate(outs):
        m = re.search(rf"^MULTIHOST_HITS process={pid} (.*)$", out, re.M)
        assert m, out[-2000:]
        got.append([[tuple(h) for h in q] for q in json.loads(m.group(1))])
    return got


def _jax_hits(num_processes, devices_per_proc):
    """The JAX package's answers on its own build of the corpus: its host
    oracle's, and its ``ShardedSearcher``'s over a mesh of ``num_processes
    x devices_per_proc`` devices, one segment a device, which is what its
    multi-process dryrun spans."""
    import jax

    from iresearch_tpu.parallel import ShardedSearcher, make_mesh
    from iresearch_tpu.parallel.multihost import _build_reader
    from iresearch_tpu.search.host_eval import search
    from iresearch_tpu.search.scorers import BM25
    from iresearch_tpu_torch.parallel.multihost import queries

    n = num_processes * devices_per_proc
    reader = _build_reader(num_docs=192 * n, segments=n)
    assert len(reader.segments) == n
    jq = [to_jax(q) for q in queries()]
    js = ShardedSearcher(list(reader.segments), make_mesh(jax.devices()[:n]))
    assert (js.D, js.per_shard) == (n, 1)
    return [search(reader, q, k=5) for q in jq], js.prepare_many(jq, BM25(), wand=True).top_k(5)


def _check(outs, num_processes, devices_per_proc):
    oracle, sharded = _jax_hits(num_processes, devices_per_proc)
    for worker in _hits(outs):
        assert len(worker) == len(oracle) == len(sharded) == 4
        for got, exp, jsh in zip(worker, oracle, sharded):
            assert len(got) == 5
            assert_topk_equiv(got, exp)
            assert_topk_equiv(got, jsh)
    for pid, out in enumerate(outs):
        assert f"MULTIHOST_OK process={pid}/{num_processes}" in out
        assert f"shards={devices_per_proc} passes=" in out


def test_dryrun_multihost_2proc_matches_jax():
    """Two processes of two shards each (``devices_per_proc`` = 2 on the
    CPU: ``mesh=cpu,cpu``) against the JAX package's 2 x 2."""
    outs = dryrun_multihost(num_processes=2, devices_per_proc=2, device="cpu")
    _check(outs, 2, 2)
    assert all("mesh=cpu,cpu" in out for out in outs)


@pytest.mark.cuda
def test_dryrun_multihost_on_one_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    outs = dryrun_multihost(num_processes=2, devices_per_proc=2, device="cuda:0")
    _check(outs, 2, 2)
    assert all("device=cuda:0" in out for out in outs)


def test_nccl_workers_need_a_card_each():
    """``mesh_devices`` on ``nccl`` gives a process its own card K times
    and refuses what would put two processes on one card or a process on
    the CPU, whatever cards the host has."""
    from iresearch_tpu_torch.parallel.multihost import mesh_devices

    assert mesh_devices(0, 1, 3, "cuda:0", backend="nccl") == [torch.device("cuda", 0)] * 3
    for device in ("cuda:0", "cpu"):
        with pytest.raises(ValueError, match="card of its own"):
            mesh_devices(0, 2, 2, device, backend="nccl")
    with pytest.raises(ValueError, match="card of its own"):
        mesh_devices(0, 1, 2, "cpu", backend="nccl")
    if torch.cuda.device_count() < 3:
        with pytest.raises(ValueError, match="needs 3 cards"):
            mesh_devices(0, 3, 1, backend="nccl")


def test_dist_calls_counts_the_calls():
    """``dist_calls`` counts calls through ``torch.distributed`` by name
    inside its block only, and puts every function back."""
    import torch.distributed as dist

    from iresearch_tpu_torch.parallel.multihost import dist_calls

    before = dist.is_initialized
    with dist_calls() as calls:
        dist.is_initialized()
        dist.is_initialized()
        dist.is_available()
    dist.is_initialized()
    assert calls == {"is_initialized": 2, "is_available": 1}
    assert dist.is_initialized is before


@pytest.mark.cuda
def test_dryrun_multihost_nccl_refuses_a_shared_card():
    """Two NCCL processes asked onto one card fail with the reason."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    with pytest.raises(RuntimeError, match="card of its own"):
        dryrun_multihost(num_processes=2, devices_per_proc=2, device="cuda:0",
                         backend="nccl", timeout=300)


@pytest.mark.cuda
def test_dryrun_multihost_nccl_two_cards():
    """Two processes of an NCCL group, one card each with two shards on
    it, against the JAX package's 2 x 2: each group one graph per process
    holding the all_gather, the replays without a call into
    ``torch.distributed``."""
    if torch.cuda.device_count() < 2:
        pytest.skip(f"needs two cards ({torch.cuda.device_count()} visible)")
    outs = dryrun_multihost(num_processes=2, devices_per_proc=2, backend="nccl")
    _check(outs, 2, 2)
    for pid, out in enumerate(outs):
        assert f"device=cuda:{pid}" in out
        join = re.search(rf"^MULTIHOST_JOIN process={pid} .*$", out, re.M).group(0)
        assert " backend=nccl join=graph " in join and " graphs_per_group=1 " in join
        assert " dist_calls=0 " in join
