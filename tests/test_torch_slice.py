"""The port's batched search path vs the JAX package's, end to end on the
CPU: the bench corpus law at 100k docs, the 400-query bench mix, BM25
top-10 with wand=True (the skyline, dslice and fused-scan tiers)."""

import os
import subprocess
import sys
from collections import Counter

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from iresearch_tpu.search import filters as F  # noqa: E402
from iresearch_tpu.search.scorers import BM25  # noqa: E402
from iresearch_tpu_torch import bench_mix  # noqa: E402
from iresearch_tpu_torch.exec.batch import QueryBatch  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K = 10


@pytest.fixture(scope="module")
def bench_reader():
    from iresearch_tpu.index.segment import SegmentReader

    return SegmentReader("slice", bench_mix.build_segment_data(100_000))


@pytest.fixture(scope="module")
def mix(bench_reader):
    return bench_mix.task_mix(bench_reader)


def _canonical(vals, docs):
    """(score desc, doc asc) order: the JAX package orders ties inside the
    top-k by lane position, the port by doc id; the sets are the same."""
    o = np.lexsort((docs, -vals))
    return vals[o], docs[o]


def test_slice_matches_jax(bench_reader, mix):
    from iresearch_tpu.exec.batch import QueryBatch as JaxQueryBatch

    filters = [f for _c, f in mix]
    want = JaxQueryBatch(filters, [bench_reader], BM25(), wand=True).prepare(0, K).run()
    prep = QueryBatch(filters, [bench_reader], BM25(), wand=True,
                      device=torch.device("cpu")).prepare(0, K)
    got = prep.run()
    assert len(got) == len(want) == 400
    for qi, ((gv, gd), (wv, wd)) in enumerate(zip(got, want)):
        wv, wd = _canonical(np.asarray(wv), np.asarray(wd))
        gv, gd = gv.numpy(), gd.numpy()
        # the port's own order is already canonical
        np.testing.assert_array_equal(_canonical(gv, gd)[1], gd)
        np.testing.assert_array_equal(gd, wd, err_msg=f"q{qi} {mix[qi][0]}")
        # same operations in the same order; rtol 1e-5 is the exactness gate
        np.testing.assert_allclose(gv, wv, rtol=1e-5, atol=0.0)
    tiers = Counter()
    for tier, qis, *_r in prep.calls:
        tiers[tier] += len(qis)
    assert set(tiers) == {"skyline", "dslice", "scan"}, tiers
    assert sum(tiers.values()) == 400


def test_slice_with_deletes_matches_jax():
    """A snapshot with deleted docs: the dslice tier masks them with the
    alive mask, the grid tiers find them zeroed in the dense cache."""
    from iresearch_tpu.exec.batch import QueryBatch as JaxQueryBatch
    from iresearch_tpu.index.segment import SegmentReader

    data = bench_mix.build_segment_data(30_000)
    dead = np.random.default_rng(8).choice(30_000, size=3_000, replace=False)
    sr = SegmentReader("deletes", data, masked_docs=dead)
    mix = bench_mix.task_mix(sr)[::4]
    filters = [f for _c, f in mix]
    want = JaxQueryBatch(filters, [sr], BM25(), wand=True).prepare(0, K).run()
    prep = QueryBatch(filters, [sr], BM25(), wand=True, device="cpu").prepare(0, K)
    assert "dslice" in {c[0] for c in prep.calls}
    for (gv, gd), (wv, wd) in zip(prep.run(), want):
        wv, wd = _canonical(np.asarray(wv), np.asarray(wd))
        np.testing.assert_array_equal(gd.numpy(), wd)
        np.testing.assert_allclose(gv.numpy(), wv, rtol=1e-5, atol=0.0)
        assert not np.isin(gd.numpy()[np.isfinite(gv.numpy())], dead).any()


def test_plain_run_equals_kernel_run_on_cpu(bench_reader, mix):
    """On CPU tensors every wrapper takes its plain version, so both runs
    are the same computation."""
    prep = QueryBatch([f for _c, f in mix[::20]], [bench_reader], BM25(),
                      wand=True, device="cpu").prepare(0, K)
    for ((v1, d1), _q1), ((v2, d2), _q2) in zip(prep.run_grouped(), prep.run_grouped(plain=True)):
        assert torch.equal(v1, v2) and torch.equal(d1, d2)


def _unported(mix):
    low = [f for c, f in mix if c == "LowTerm"]
    high = [f for c, f in mix if c == "HighTerm"]
    return {
        "join": F.And(low[0], low[1]),
        "sort": F.Or(low[0], low[1]),
        "gridmix": F.Or(high[0], low[0]),
        "aux": F.ByPhrase("body", [high[0].term, high[1].term]),
    }


@pytest.mark.parametrize("tier", ["join", "sort", "gridmix", "aux"])
def test_unported_tier_raises(bench_reader, mix, tier):
    flt = _unported(mix)[tier]
    with pytest.raises(NotImplementedError, match=tier):
        QueryBatch([flt], [bench_reader], BM25(), wand=True, device="cpu").prepare(0, K)


def test_query_batch_needs_a_device(bench_reader, mix):
    with pytest.raises(TypeError):
        QueryBatch([mix[0][1]], [bench_reader], BM25())


_NO_JAX = r"""
import sys
sys.modules["jax"] = None
import torch
from iresearch_tpu.index.segment import SegmentReader
from iresearch_tpu.search.scorers import BM25
import iresearch_tpu_torch
from iresearch_tpu_torch import bench_mix
from iresearch_tpu_torch.exec.batch import QueryBatch

sr = SegmentReader("tiny", bench_mix.build_segment_data(5000))
mix = bench_mix.task_mix(sr)
prep = QueryBatch([f for _c, f in mix], [sr], BM25(), wand=True,
                  device="cpu").prepare(0, 10)
out = prep.run()
assert len(out) == 400 and all(v.shape == (10,) for v, _d in out)
assert all(torch.isfinite(v[0]) for (c, _f), (v, _d) in zip(mix, out) if c == "HighTerm")
loaded = [m for m in sys.modules if m == "jax" or m.startswith("jax.")]
assert sys.modules["jax"] is None and loaded == ["jax"], loaded
assert "iresearch_tpu.exec.executor" not in sys.modules
print("tiers", sorted({c[0] for c in prep.calls}))
"""


def test_port_runs_without_jax():
    path = os.environ.get("PYTHONPATH")
    env = dict(os.environ, PYTHONPATH=REPO + (os.pathsep + path if path else ""))
    r = subprocess.run(
        [sys.executable, "-c", _NO_JAX], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert r.returncode == 0, r.stderr[-3000:]
    assert "tiers" in r.stdout
