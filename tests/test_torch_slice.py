"""The port's batched search path vs the JAX package's, end to end on the
CPU: the bench corpus law at 100k docs, the 400-query bench mix, BM25
top-10 with wand=True (the skyline, dslice and fused-scan tiers), plus
one query each of the join, sort, gridmix and aux tiers, and every tier
in a process that imports neither jax nor the JAX package. The JAX
package builds each segment; the port gets it through ``carry`` and its
filters and scorers through ``to_port`` (``tests/test_torch_carry.py``)."""

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
from test_torch_carry import carry, jax_bench_reader, to_jax, to_port  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K = 10


@pytest.fixture(scope="module")
def bench_reader():
    """(JAX reader, the port's carried reader) of the 100k-doc segment."""
    sr = jax_bench_reader("slice", 100_000)
    return sr, carry(sr)


@pytest.fixture(scope="module")
def mix(bench_reader):
    """The bench mix as (category, JAX filter)."""
    return [(c, to_jax(f)) for c, f in bench_mix.task_mix(bench_reader[1])]


def _port_batch(filters, psr, **kw):
    return QueryBatch([to_port(f) for f in filters], [psr], to_port(BM25()),
                      device="cpu", **kw)


def _canonical(vals, docs):
    """(score desc, doc asc) order: the JAX package orders ties inside the
    top-k by lane position, the port by doc id; the sets are the same."""
    o = np.lexsort((docs, -vals))
    return vals[o], docs[o]


def test_slice_matches_jax(bench_reader, mix):
    from iresearch_tpu.exec.batch import QueryBatch as JaxQueryBatch

    sr, psr = bench_reader
    filters = [f for _c, f in mix]
    want = JaxQueryBatch(filters, [sr], BM25(), wand=True).prepare(0, K).run()
    prep = _port_batch(filters, psr, wand=True).prepare(0, K)
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

    dead = np.random.default_rng(8).choice(30_000, size=3_000, replace=False)
    sr = jax_bench_reader("deletes", 30_000, masked_docs=dead)
    psr = carry(sr)
    assert psr.has_deletes
    filters = [to_jax(f) for _c, f in bench_mix.task_mix(psr)[::4]]
    want = JaxQueryBatch(filters, [sr], BM25(), wand=True).prepare(0, K).run()
    prep = _port_batch(filters, psr, wand=True).prepare(0, K)
    assert "dslice" in {c[0] for c in prep.calls}
    for (gv, gd), (wv, wd) in zip(prep.run(), want):
        wv, wd = _canonical(np.asarray(wv), np.asarray(wd))
        np.testing.assert_array_equal(gd.numpy(), wd)
        np.testing.assert_allclose(gv.numpy(), wv, rtol=1e-5, atol=0.0)
        assert not np.isin(gd.numpy()[np.isfinite(gv.numpy())], dead).any()


def test_plain_run_equals_kernel_run_on_cpu(bench_reader, mix):
    """On CPU tensors every wrapper takes its plain version, so both runs
    are the same computation."""
    prep = _port_batch([f for _c, f in mix[::20]], bench_reader[1], wand=True).prepare(0, K)
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

    sr, psr = bench_reader
    mix = [(c, to_jax(f)) for c, f in bench_mix.task_mix(psr)]
    flt = _new_tiers(mix)[tier]
    prep = _port_batch([flt], psr, wand=True).prepare(0, K)
    assert [c[0] for c in prep.calls] == [tier]
    (gv, gd), = prep.run()
    gv, gd = gv.numpy(), gd.numpy()
    (wv, wd), = JaxQueryBatch([flt], [sr], BM25(), wand=True).prepare(0, K).run()
    wv, wd = np.asarray(wv), np.asarray(wd)
    fin = np.isfinite(gv)
    np.testing.assert_array_equal(fin, np.isfinite(wv))
    np.testing.assert_allclose(np.sort(gv[fin]), np.sort(wv[fin]), rtol=1e-5, atol=1e-6)
    got = [(int(d), float(v)) for d, v in zip(gd[fin], gv[fin])]
    assert_topk_equiv(got, [(int(d), float(v)) for d, v in zip(wd[fin], wv[fin])])
    assert_topk_equiv(got, HostQuery(flt, [sr], BM25()).top_k(K))


def test_query_batch_needs_a_device(bench_reader, mix):
    """Without a ``device`` the batch runs on the card, and raises where
    there is none; it takes none of the JAX package's objects."""
    sr, psr = bench_reader
    flt, scorer = to_port(mix[0][1]), to_port(BM25())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            QueryBatch([flt], [psr], scorer)
    with pytest.raises(TypeError, match="SegmentReader"):
        QueryBatch([flt], [sr], scorer, device="cpu")
    with pytest.raises(TypeError, match="Scorer"):
        QueryBatch([flt], [psr], BM25(), device="cpu")
    with pytest.raises(TypeError, match="Filter"):
        QueryBatch([mix[0][1]], [psr], scorer, device="cpu")


_SLICE = r"""
import sys
import torch
from iresearch_tpu_torch import bench_mix
from iresearch_tpu_torch.exec.batch import QueryBatch
from iresearch_tpu_torch.exec.executor import DeviceQuery
from iresearch_tpu_torch.index.segment import SegmentReader
from iresearch_tpu_torch.search.scorers import BM25

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
    single.append(dq.single_call(0, 10).tier)
prep = qb.prepare(0, 10)
assert [c[0] for c in prep.calls] == [t for t, _f, _k in tt], prep.calls
assert single == [t for t, _f, _k in tt], single
assert all(v.shape == (10,) for v, _d in prep.run())
breadth = [DeviceQuery(f, [sr], BM25(), wand=w, device="cpu")
           for n, f, w in bench_mix.breadth_tasks(sr)]
assert breadth[0].plan(0).device_aux  # Phrase, on the device by default
assert all(q.execute_segment_async(0, 10)[0].shape == (10,) for q in breadth)
print("new tiers", [c[0] for c in prep.calls])

# the sharded executor over two segments, a phrase among its queries in the
# keys form, and the store and utils copies
import iresearch_tpu_torch.store.codecs, iresearch_tpu_torch.store.directory  # noqa: E401
import iresearch_tpu_torch.utils.log, iresearch_tpu_torch.utils.pools  # noqa: E401
import iresearch_tpu_torch.utils.resource, iresearch_tpu_torch.utils.timer  # noqa: E401
from iresearch_tpu_torch.parallel import ShardedSearcher

sr2 = SegmentReader("tiny2", bench_mix.build_segment_data(2000, bench_mix.SEED + 1))
flts = [f for _c, f in mix[::40]] + [bench_mix.breadth_tasks(sr)[0][1]]
sp = ShardedSearcher([sr, sr2], device="cpu").prepare_many(flts, BM25(), wand=True, k_max=10)
assert any(kw.get("phrase_keys") for _t, _q, _f, _a, kw in sp.calls)
assert all(v.shape == (10,) for v, _d in sp.run(10))
print("sharded tiers", sorted({c[0] for c in sp.calls}))

# ingest: analyzers, the writer (flushes inverted on the device), commit,
# consolidation, a delete and the reader, then the index served
from iresearch_tpu_torch import analysis
from iresearch_tpu_torch.index.consolidate import consolidate_count
from iresearch_tpu_torch.index.reader import DirectoryReader
from iresearch_tpu_torch.index.writer import Field, IndexWriter, IndexWriterOptions
from iresearch_tpu_torch.search import filters as F
from iresearch_tpu_torch.store.directory import MemoryDirectory
import iresearch_tpu_torch.utils.plugins  # noqa: F401

d = MemoryDirectory()
buf, starts, ends = bench_mix.corpus_text(300)
with IndexWriter(d, IndexWriterOptions(segment_docs_max=128), device="cpu") as w:
    for i, (s, e) in enumerate(zip(starts.tolist(), ends.tolist())):
        w.insert([Field("body", buf[s:e].decode(), analyzer="segmentation"),
                  Field("title", "Füße laufen %d" % i, analyzer="text"),
                  Field("n", i, analyzer="numeric", store=True)])
    w.commit()
    assert w.consolidate(consolidate_count())
    w.remove(F.ByTerm("title", analysis.get("text").terms("laufen")[0]))
    w.commit()
r = DirectoryReader.open(d)
assert [sr.num_docs for sr in r.segments] == [300] and r.live_docs_count == 0
w = IndexWriter(d, IndexWriterOptions(), device="cpu")
w.insert([Field("body", "t000001 t000002", analyzer="segmentation")])
w.commit()
r = DirectoryReader.open(d)
v, dd = QueryBatch([F.ByTerm("body", "t000001")], r.segments, BM25(),
                   device="cpu").prepare_all(10).run()
assert int(dd[0, 0]) == 300 and torch.isfinite(v[0, 0])
print("ingest ok", sorted(analysis.registered()))

# the surfaces: the CLI (put, then search on the device engine), the
# pyresearch facade, an embedding model trained with autograd, and the
# multi-process dryrun's module
import tempfile
from iresearch_tpu_torch import pyresearch
from iresearch_tpu_torch.analysis.embed import train_supervised
from iresearch_tpu_torch.cli.__main__ import main as cli
import iresearch_tpu_torch.parallel.multihost  # noqa: F401

with tempfile.TemporaryDirectory() as tmp:
    with open(tmp + "/lines.txt", "w") as f:
        for i, (s, e) in enumerate(zip(starts.tolist(), ends.tolist())):
            f.write("doc%d\t2012-05-02\t%s\n" % (i, buf[s:e].decode()))
    assert cli(["put", "--in", tmp + "/lines.txt", "--index-dir", tmp + "/idx",
                "--device", "cpu"]) == 0
    with open(tmp + "/tasks.txt", "w") as f:
        f.write("HighTerm: t000001 # 9\nOrHighMed: t000002 t000150 # 9\n")
    assert cli(["search", "--in", tmp + "/tasks.txt", "--index-dir", tmp + "/idx",
                "--engine", "device", "--device", "cpu", "--csv"]) == 0
    assert pyresearch.index_reader.open(tmp + "/idx").docs_count() == 300
texts = [buf[s:e].split() for s, e in zip(starts.tolist()[:40], ends.tolist()[:40])]
m = train_supervised(texts, [b"a" if len(t) % 2 else b"b" for t in texts], epochs=3,
                     buckets=64, device="cpu")
assert m.losses.shape == (3,) and m.predict(texts[0])
print("surfaces ok")

loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "iresearch_tpu"))
assert loaded == sorted(BLOCKED), loaded[:8]
print("imports ok")
"""


def _run_slice(blocked):
    """The slice above in a fresh interpreter with ``blocked`` modules
    made unimportable (``sys.modules[name] = None``)."""
    path = os.environ.get("PYTHONPATH")
    env = dict(os.environ, PYTHONPATH=REPO + (os.pathsep + path if path else ""))
    head = f"import sys\nBLOCKED = {blocked!r}\nfor m in BLOCKED:\n    sys.modules[m] = None\n"
    r = subprocess.run(
        [sys.executable, "-c", head + _SLICE], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert r.returncode == 0, r.stderr[-3000:]
    assert "tiers" in r.stdout and "new tiers" in r.stdout and "imports ok" in r.stdout
    assert "sharded tiers" in r.stdout and "ingest ok" in r.stdout
    assert "surfaces ok" in r.stdout and "HighTerm,1," in r.stdout


def test_port_leaves_installed_jax_unimported():
    """Where jax and the JAX package are installed, a slice of the mix, the
    breadth categories, the tier batch, a sharded batch (with the store
    and utils copies imported) and an index written, consolidated and
    served through the port's analyzers, writer and reader leaves both
    unimported, as do the CLI (put, search on the device engine),
    pyresearch, a tiny embedding model trained on the CPU and the
    multi-process module: no ``jax``, no ``iresearch_tpu`` and no
    ``iresearch_tpu.*`` module."""
    _run_slice([])


def test_port_runs_without_jax():
    """The same slice where neither jax nor the JAX package can import."""
    _run_slice(["jax", "iresearch_tpu"])
