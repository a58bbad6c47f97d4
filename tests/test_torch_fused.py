"""The port's fused pass (``exec/batch.py``: ``_pack_args``, ``_materialize``,
``_template_key``, ``_FUSED_CACHE``, ``clear_fused_cache``,
``PreparedBatch.run_grouped(fused=True)``) vs its eager path and the JAX
package's fused run, on the CPU.

On the CPU a fused run takes the cache entry and the buffer copy that it
takes on the card, and runs the entry's bodies eagerly over the entry's
buffer (there is no graph), so these tests check the packing and the reuse
of entries; the graph's own cases are ``cuda``-marked in
``tests/test_torch_kernels.py``. The JAX package builds the seeded
20,000-doc bench-law segment (``jax_bench_reader``) and the port gets it
through ``carry``: the mix's scan and dslice groups, and one query per
tier that decodes postings rows (fold, aux, wand, direct, sort, join,
gridmix; planner knobs set in both packages for that query's plan). Port
against port: bit for bit. Port against the JAX package's
``run_grouped(fused=True)``: docs equal except for swaps inside near-ties,
scores to rtol 1e-5 (``assert_topk_near``; the JAX top-k orders interior
ties by no rule, ROADMAP item e).
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from iresearch_tpu.exec.batch import QueryBatch as JaxQueryBatch  # noqa: E402
from iresearch_tpu.search.scorers import BM25  # noqa: E402
from iresearch_tpu_torch import bench_mix  # noqa: E402
from iresearch_tpu_torch.exec import batch as B  # noqa: E402
from iresearch_tpu_torch.exec.batch import QueryBatch  # noqa: E402
from iresearch_tpu_torch.search import filters as F  # noqa: E402
from test_torch_carry import Segs, both_knobs, carry, jax_bench_reader, to_jax, to_port  # noqa: E402
from test_torch_exec import assert_topk_near  # noqa: E402

CPU = torch.device("cpu")
K = 10


@pytest.fixture(scope="module")
def bench():
    sr = jax_bench_reader("fused20k", 20_000)
    return Segs([sr], [carry(sr)])


@pytest.fixture(autouse=True)
def empty_cache():
    B.clear_fused_cache()
    yield
    B.clear_fused_cache()


def _mix(segs):
    return [f for _c, f in bench_mix.task_mix(segs.port[0])[::8]]


def _batches(segs, name="mix", filters=None, knobs=None):
    """(port QueryBatch, JAX QueryBatch) of the mix (every 8th query), of
    the tier tasks (each tier query planned under its knobs in both) or of
    ``filters`` (planned under ``knobs``)."""
    if name == "tiers":
        tasks = bench_mix.tier_tasks(segs.port[0])
        filters = [f for _t, f, _k in tasks]
    else:
        filters = _mix(segs) if filters is None else filters
        tasks = [(None, f, knobs or {}) for f in filters]
    port = QueryBatch(filters, segs.port, to_port(BM25()), wand=True, device=CPU)
    ref = JaxQueryBatch(to_jax(tuple(filters)), segs.jax, BM25(), wand=True)
    for tq, jq, (_t, _f, kv) in zip(port.queries, ref.queries, tasks):
        if kv:
            with both_knobs(**kv):
                tq.plan(0), jq.plan(0)
    return port, ref


def _per_query(grouped, n):
    out = [None] * n
    for (vals, docs), qis in grouped:
        for j, qi in enumerate(qis):
            out[qi] = (np.asarray(vals[j]), np.asarray(docs[j]))
    return out


def _assert_same(got, want):
    assert len(got) == len(want)
    for ((gv, gd), qg), ((wv, wd), qw) in zip(got, want):
        assert qg == qw
        assert gv.dtype == wv.dtype and gd.dtype == wd.dtype
        assert torch.equal(gv, wv) and torch.equal(gd, wd)


def _assert_near_jax(got, jax_prep, n):
    for g, w in zip(_per_query(got, n), _per_query(jax_prep.run_grouped(fused=True), n)):
        assert_topk_near(g, w)


def _compare_tree(view, raw, buf):
    """Leaves compared: each packed host array against the upload that
    ``group_call`` made of it before (``torch.from_numpy(...).to(dev)``),
    bit for bit, on a 256-byte boundary of ``buf``."""
    if isinstance(raw, np.ndarray):
        want = torch.from_numpy(np.ascontiguousarray(raw))
        assert view.dtype == want.dtype and view.shape == want.shape
        assert torch.equal(view.reshape(-1).view(torch.uint8), want.reshape(-1).view(torch.uint8))
        assert (view.data_ptr() - buf.data_ptr()) % B._ALIGN == 0
        assert buf.data_ptr() <= view.data_ptr() <= buf.data_ptr() + buf.numel()
        return 1
    if type(raw) is tuple:
        assert type(view) is tuple and len(view) == len(raw)
        return sum(_compare_tree(v, r, buf) for v, r in zip(view, raw))
    assert view is raw
    return 0


TIERS = {"scan": "mix", "dslice": "mix", "fold": "tiers", "aux": "tiers", "wand": "tiers",
         "direct": "tiers", "sort": "tiers", "join": "tiers", "gridmix": "tiers"}


@pytest.mark.parametrize("tier", sorted(TIERS))
def test_pack_args_equals_uploads(bench, monkeypatch, tier):
    """Every host-made argument of the tier's group, rebuilt from the
    packed buffer, equals the upload it replaces: dtype, shape and bits,
    its section 256-byte aligned; the segment's tensors pass as they are."""
    seen = []
    real = B._pack_args
    monkeypatch.setattr(B, "_pack_args", lambda trees, dev: seen.append(trees) or real(trees, dev))
    port, _ref = _batches(bench, TIERS[tier])
    prep = port.prepare(0, K)
    (trees,) = seen
    calls = [(c, raw) for c, raw in zip(prep.calls, trees) if c[0] == tier]
    assert calls, [c[0] for c in prep.calls]
    for (_t, _q, _fn, args, _kw), raw in calls:
        assert _compare_tree(args, raw, prep._buf) > 0
    # the eager path over those views equals the fused pass
    _assert_same(prep.run_grouped(fused=True), prep.run_grouped(fused=False))


def test_template_key_follows_structure(bench):
    """Two fresh prepares of the same queries: equal keys (in both
    packages). A lone term in another row bucket (High terms kept sparse:
    64 and 16 rows): another key (in both). The same queries on another
    segment (a second carry of the same data, its own pools): another key
    in the port, whose graphs read each segment's own addresses."""
    port, ref = _batches(bench)
    again, ref_again = _batches(bench)
    key = port.prepare(0, K)._key
    assert key == again.prepare(0, K)._key
    assert ref.prepare(0, K)._key == ref_again.prepare(0, K)._key
    _at, high, _med, _low = bench_mix._ranked(bench.port[0])
    terms = [F.ByTerm("body", high[i]) for i in (16, 40)]
    pairs = [_batches(bench, filters=[f], knobs=dict(USE_DENSE_TERMS=False)) for f in terms]
    rows = [len(p.queries[0].plan(0).groups[0].rows_d) for p, _r in pairs]
    assert B._bucket4(rows[0]) != B._bucket4(rows[1]), rows
    assert pairs[0][0].prepare(0, K)._key != pairs[1][0].prepare(0, K)._key
    assert pairs[0][1].prepare(0, K)._key != pairs[1][1].prepare(0, K)._key
    other = Segs(bench.jax, [carry(bench.jax[0])])
    moved = _batches(other)[0].prepare(0, K)._key
    assert moved != key and moved[0] == key[0]  # templates and kwargs alike


def test_fused_cache_is_lru_bounded(bench, monkeypatch):
    """``_FUSED_CACHE`` holds at most ``_FUSED_CACHE_MAX`` entries
    (``IRS_FUSED_CACHE_MAX``, 256 by default), drops the least recently
    run first, and ``clear_fused_cache`` empties it."""
    assert B._FUSED_CACHE_MAX == int(os.environ.get("IRS_FUSED_CACHE_MAX", "256"))
    monkeypatch.setattr(B, "_FUSED_CACHE_MAX", 2)
    port, _ref = _batches(bench)
    preps = [port.prepare(0, k) for k in (K, K - 1, K - 2)]  # k is in the key
    keys = [p._key for p in preps]
    assert len(set(keys)) == 3
    preps[0].run_grouped()
    preps[1].run_grouped()
    assert list(B._FUSED_CACHE) == keys[:2]
    preps[0].run_grouped()  # the newest again
    preps[2].run_grouped()
    assert list(B._FUSED_CACHE) == [keys[0], keys[2]]
    B.clear_fused_cache()
    assert not B._FUSED_CACHE


def test_fresh_batch_hit_copies_its_buffer(bench):
    """A fresh batch of the same structure (two queries of one group
    swapped, so its packed rows differ) hits the entry that the first batch
    made, and returns exactly its own ``fused=False`` results, not the
    first batch's; what the first call returned is unchanged. Both batches
    against the JAX package's fused run."""
    port, ref = _batches(bench)
    filters = _mix(bench)
    first = port.prepare(0, K)
    got1 = first.run_grouped()
    kept = [(v.clone(), d.clone()) for (v, d), _q in got1]
    entry = B._FUSED_CACHE[first._key]
    a, b = next(qis[:2] for _t, qis, *_r in first.calls
                if len(qis) >= 2 and filters[qis[0]] != filters[qis[1]])
    swapped = list(filters)
    swapped[a], swapped[b] = swapped[b], swapped[a]
    port2, ref2 = _batches(bench, filters=swapped)
    fresh = port2.prepare(0, K)
    assert fresh._key == first._key and not torch.equal(fresh._buf, first._buf)
    got2 = fresh.run_grouped()
    assert len(B._FUSED_CACHE) == 1 and B._FUSED_CACHE[first._key] is entry
    _assert_same(got2, fresh.run_grouped(fused=False))
    one, two = _per_query(got1, len(filters)), _per_query(got2, len(filters))
    assert not np.array_equal(one[a][1], two[a][1])
    np.testing.assert_array_equal(one[a][1], two[b][1])
    for ((v, d), _q), (kv, kd) in zip(got1, kept):
        assert torch.equal(v, kv) and torch.equal(d, kd)
    _assert_near_jax(got1, ref.prepare(0, K), len(filters))
    _assert_near_jax(got2, ref2.prepare(0, K), len(filters))


@pytest.mark.parametrize("name", ["mix", "tiers"])
def test_fused_pass_equals_eager_and_jax(bench, name):
    """One fused pass over every group equals the eager groups and the
    plain run bit for bit, and the JAX package's fused run."""
    port, ref = _batches(bench, name)
    prep = port.prepare(0, K)
    if name == "tiers":
        assert [c[0] for c in prep.calls] == [t for t, _f, _k in bench_mix.tier_tasks(bench.port[0])]
    got = prep.run_grouped()
    _assert_same(got, prep.run_grouped(fused=False))
    _assert_same(got, prep.run_grouped(plain=True))
    _assert_near_jax(got, ref.prepare(0, K), len(port.queries))
    per = prep.run()
    for qi, (v, d) in enumerate(_per_query(got, len(port.queries))):
        np.testing.assert_array_equal(per[qi][0].numpy(), v)
        np.testing.assert_array_equal(per[qi][1].numpy(), d)
