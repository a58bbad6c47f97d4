"""The port's batched search path vs the JAX package's, end to end on the
CPU: the bench corpus law at 100k docs, the 400-query bench mix, BM25
top-10 with wand=True (the skyline, dslice and fused-scan tiers), plus
one query each of the join, sort, gridmix and aux tiers, and every tier
with jax blocked."""

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


def _new_tiers(mix):
    low = [f for c, f in mix if c == "LowTerm"]
    high = [f for c, f in mix if c == "HighTerm"]
    return {
        "join": F.And(low[0], low[1]),
        "sort": F.Or(low[0], low[1]),
        "gridmix": F.Or(high[0], low[0]),
        "aux": F.ByPhrase("body", [high[0].term, high[1].term]),
    }


@pytest.mark.parametrize("tier", ["join", "sort", "gridmix", "aux"])
def test_new_tier_matches_jax(bench_reader, tier):
    """Shapes beyond the bench mix at 100k docs, each through its own tier:
    the port's QueryBatch against the JAX package's and the numpy oracle
    (scores rtol 1e-5, docs up to near-tie swaps)."""
    from iresearch_tpu.exec.batch import QueryBatch as JaxQueryBatch
    from iresearch_tpu.search.host_eval import HostQuery
    from tests.topk_util import assert_topk_equiv

    mix = bench_mix.task_mix(bench_reader)
    flt = _new_tiers(mix)[tier]
    prep = QueryBatch([flt], [bench_reader], BM25(), wand=True, device="cpu").prepare(0, K)
    assert [c[0] for c in prep.calls] == [tier]
    (gv, gd), = prep.run()
    gv, gd = gv.numpy(), gd.numpy()
    (wv, wd), = JaxQueryBatch([flt], [bench_reader], BM25(), wand=True).prepare(0, K).run()
    wv, wd = np.asarray(wv), np.asarray(wd)
    fin = np.isfinite(gv)
    np.testing.assert_array_equal(fin, np.isfinite(wv))
    np.testing.assert_allclose(np.sort(gv[fin]), np.sort(wv[fin]), rtol=1e-5, atol=1e-6)
    got = [(int(d), float(v)) for d, v in zip(gd[fin], gv[fin])]
    assert_topk_equiv(got, [(int(d), float(v)) for d, v in zip(wd[fin], wv[fin])])
    assert_topk_equiv(got, HostQuery(flt, [bench_reader], BM25()).top_k(K))


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
from iresearch_tpu_torch.exec.executor import DeviceQuery

sr = SegmentReader("tiny", bench_mix.build_segment_data(5000))
mix = bench_mix.task_mix(sr)
prep = QueryBatch([f for _c, f in mix], [sr], BM25(), wand=True,
                  device="cpu").prepare(0, 10)
out = prep.run()
assert len(out) == 400 and all(v.shape == (10,) for v, _d in out)
assert all(torch.isfinite(v[0]) for (c, _f), (v, _d) in zip(mix, out) if c == "HighTerm")
print("tiers", sorted({c[0] for c in prep.calls}))

# one query of each new tier, batched and single, each plan under its knobs
tt = bench_mix.tier_tasks(sr)
qb = QueryBatch([f for _t, f, _k in tt], [sr], BM25(), wand=True, device="cpu")
single = []
for q, (tier, flt, knobs) in zip(qb.queries, tt):
    with bench_mix.planner_knobs(**knobs):
        q.plan(0)
        dq = DeviceQuery(flt, [sr], BM25(), wand=True, device_phrase=False, device="cpu")
        dq.plan(0)
    v, d = dq.execute_segment(0, 10)
    assert v.shape == d.shape and 0 < len(v) <= 10
    single.append(dq.call(0, 10)[0])
prep = qb.prepare(0, 10)
assert [c[0] for c in prep.calls] == [t for t, _f, _k in tt], prep.calls
assert single == [t for t, _f, _k in tt], single
assert all(v.shape == (10,) for v, _d in prep.run())
breadth = [DeviceQuery(f, [sr], BM25(), wand=w, device="cpu")
           for n, f, w in bench_mix.breadth_tasks(sr) if n != "Phrase"]
assert all(q.execute_segment_async(0, 10)[0].shape == (10,) for q in breadth)
print("new tiers", [c[0] for c in prep.calls])

loaded = [m for m in sys.modules if m == "jax" or m.startswith("jax.")]
assert sys.modules["jax"] is None and loaded == ["jax"], loaded
assert "iresearch_tpu.exec.executor" not in sys.modules
"""


_JAX_INSTALLED = r"""
import sys
from iresearch_tpu.index.segment import SegmentReader
from iresearch_tpu.search.scorers import BM25
from iresearch_tpu_torch import bench_mix
from iresearch_tpu_torch.exec.executor import DeviceQuery

sr = SegmentReader("tiny", bench_mix.build_segment_data(3000))
for _tier, flt, _knobs in bench_mix.tier_tasks(sr):
    DeviceQuery(flt, [sr], BM25(), wand=True, device_phrase=False,
                device="cpu").execute_segment(0, 10)
loaded = [m for m in sys.modules if m.split(".")[0] == "jax"]
assert not loaded and "iresearch_tpu.exec.executor" not in sys.modules, loaded[:5]
import iresearch_tpu.exec as ex  # the JAX package still imports on demand
assert ex.DeviceQuery.__module__ == "iresearch_tpu.exec.executor"
print("lazy")
"""


def test_port_leaves_installed_jax_unimported():
    """Where jax is installed, the port still imports none of it; the JAX
    package's ``iresearch_tpu.exec`` names load when first asked for."""
    path = os.environ.get("PYTHONPATH")
    env = dict(os.environ, PYTHONPATH=REPO + (os.pathsep + path if path else ""))
    r = subprocess.run(
        [sys.executable, "-c", _JAX_INSTALLED], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert r.returncode == 0, r.stderr[-3000:]
    assert "lazy" in r.stdout


def test_port_runs_without_jax():
    path = os.environ.get("PYTHONPATH")
    env = dict(os.environ, PYTHONPATH=REPO + (os.pathsep + path if path else ""))
    r = subprocess.run(
        [sys.executable, "-c", _NO_JAX], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert r.returncode == 0, r.stderr[-3000:]
    assert "tiers" in r.stdout and "new tiers" in r.stdout
