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
