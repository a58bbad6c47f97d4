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


def test_fused_cache_counts_hits_misses_evictions(bench, monkeypatch):
    """``fused_cache_stats()`` counts the "batch" LRU's lookups as
    ``test_fused_cache_is_lru_bounded`` makes them; clearing the cache
    keeps the counts, and on the CPU nothing is captured."""
    monkeypatch.setattr(B, "_FUSED_CACHE_MAX", 2)
    port, _ref = _batches(bench)
    preps = [port.prepare(0, k) for k in (K, K - 1, K - 2)]
    before = B.fused_cache_stats()
    for i in (0, 1, 0, 2, 1):  # miss, miss, hit, miss evicting 1, miss evicting 0
        preps[i].run_grouped()
    B.clear_fused_cache()
    after = B.fused_cache_stats()
    got = {name: after["batch"][name] - before["batch"][name] for name in after["batch"]}
    assert got == {"hits": 1, "misses": 4, "evictions": 2, "captures": 0,
                   "capture_s": 0.0, "nodes": 0}
    assert after["single"] == before["single"] and after["sharded"] == before["sharded"]


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


# --- the single query: one fused entry per call signature ---------------------


def _single_pair(segs, flt, wand=False, knobs=None, device_phrase=True):
    """(port DeviceQuery, JAX DeviceQuery) of ``flt``, each plan compiled
    under ``knobs`` in both packages."""
    from iresearch_tpu.exec import DeviceQuery as JaxDeviceQuery
    from iresearch_tpu_torch.exec.executor import DeviceQuery

    port = DeviceQuery(flt, segs.port, to_port(BM25()), wand=wand,
                       device_phrase=device_phrase, device=CPU)
    ref = JaxDeviceQuery(to_jax(flt), segs.jax, BM25(), wand=wand, device_phrase=device_phrase)
    with both_knobs(**(knobs or {})):
        port.plan(0), ref.plan(0)
    return port, ref


def _single_entry(dq, k=K):
    return B._FUSED_KINDS["single"].get(dq.single_call(0, k).fused_entry()[0])


# the skyline tier at 20,000 docs (a grid of 160 rows): 8 x the least
# bucket of 8 survivor rows, where the planners' default of 48 wants 384
_SKYLINE_RATIO = 8


@pytest.mark.parametrize("tier", sorted(["skyline", "scan", "dslice", "fold", "aux", "wand",
                                         "direct", "sort", "join", "gridmix", "phrase"]))
def test_single_query_fused_equals_eager_and_jax(bench, monkeypatch, tier):
    """``execute_segment`` (fused by default) makes one "single" entry and
    equals ``fused=False`` and the plain run bit for bit, and the JAX
    package's ``DeviceQuery``; a second run hits that entry and returns the
    same."""
    import iresearch_tpu.exec.skyline as jax_skyline
    import iresearch_tpu_torch.exec.skyline as port_skyline

    if tier == "skyline":
        for mod in (jax_skyline, port_skyline):
            monkeypatch.setattr(mod, "SKYLINE_SCAN_RATIO", _SKYLINE_RATIO)
    flt, wand, knobs, dp = bench_mix.single_tier_tasks(bench.port[0])[tier]
    port, ref = _single_pair(bench, flt, wand, knobs, dp)
    assert port.single_call(0, K).tier == ("aux" if tier == "phrase" else tier)
    assert bool(port.plan(0).device_aux) == (tier == "phrase")
    got = port.execute_segment(0, K)
    entry = _single_entry(port)
    assert entry is not None and entry.hits == 0 and not B._FUSED_CACHE
    for other in (port.execute_segment(0, K, fused=False), port.execute_segment(0, K, plain=True)):
        np.testing.assert_array_equal(got[0], other[0])
        np.testing.assert_array_equal(got[1], other[1])
    assert_topk_near(got, ref.execute_segment(0, K))
    again = port.execute_segment(0, K)
    assert entry.hits == 1 and len(B._FUSED_KINDS["single"]) == 1
    np.testing.assert_array_equal(again[1], got[1])
    np.testing.assert_array_equal(again[0], got[0])


def test_phrase_rows_kept_once(bench):
    """A phrase's fused entry reads the plan's rows from one buffer, and
    the rows that the eager run reads are views of that same buffer: the
    plan keeps one copy of them."""
    flt, wand, knobs, dp = bench_mix.single_tier_tasks(bench.port[0])["phrase"]
    port = _single_pair(bench, flt, wand, knobs, dp)[0]
    call = port.single_call(0, K)
    rows = next(x for x in call._dev_args if callable(x))
    _key, bufs, _body = call.fused_entry()
    flat = bufs[1]
    assert rows.flat()[0] is flat and flat.nbytes == 5 * sum(m.numel() for m, _s in rows(B.KERNELS))
    for m, s in rows(B.KERNELS):
        for t in (m, s):
            assert t.untyped_storage().data_ptr() == flat.untyped_storage().data_ptr()
    got = port.execute_segment(0, K)
    want = port.execute_segment(0, K, fused=False)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def _fresh_same_signature(segs, flt, others, **kw):
    """(``flt``'s DeviceQuery, the first filter of ``others`` whose query
    has its fused key and another eager result)."""
    first = _single_pair(segs, flt, **kw)[0]
    key = first.single_call(0, K).fused_entry()[0]
    docs = first.execute_segment(0, K, fused=False)[1]
    for f in others:
        dq = _single_pair(segs, f, **kw)[0]
        if dq.single_call(0, K).fused_entry()[0] == key and not np.array_equal(
                dq.execute_segment(0, K, fused=False)[1], docs):
            return first, f
    raise AssertionError("no other filter of the same signature")


def test_fresh_single_query_same_signature_hits(bench):
    """A fresh ``DeviceQuery`` of another filter with the same tier, row
    buckets and static arguments hits the entry that the first made (a
    dslice term, a dense term under WAND, a phrase whose rows are copied
    in) and returns its own ``fused=False`` result and the JAX package's,
    the first query's result unchanged. Another ``k`` or another row
    bucket misses."""
    sr = bench.port[0]
    term_at, high, _med, low = bench_mix._ranked(sr)
    T = lambda t: F.ByTerm("body", t)  # noqa: E731
    cases = [
        (T(low[0]), [T(t) for t in low[1:]], {}),
        (F.Or(T(high[0]), T(high[1])), [F.Or(T(high[i]), T(high[i + 1])) for i in range(2, 40)],
         dict(wand=True)),
        (F.ByPhrase("body", [term_at(30), term_at(31)]),
         [F.ByPhrase("body", [term_at(i), term_at(i + 1)]) for i in range(10, 40)], {}),
    ]
    for flt, others, kw in cases:
        first, other = _fresh_same_signature(bench, flt, others, **kw)
        got1 = first.execute_segment(0, K)
        kept = [a.copy() for a in got1]
        entry = _single_entry(first)
        n = len(B._FUSED_KINDS["single"])
        fresh, ref = _single_pair(bench, other, **kw)
        got2 = fresh.execute_segment(0, K)
        assert _single_entry(fresh) is entry and entry.hits == 1
        assert len(B._FUSED_KINDS["single"]) == n
        want = fresh.execute_segment(0, K, fused=False)
        np.testing.assert_array_equal(got2[0], want[0])
        np.testing.assert_array_equal(got2[1], want[1])
        assert not np.array_equal(got1[1], got2[1])
        assert_topk_near(got2, ref.execute_segment(0, K))
        np.testing.assert_array_equal(got1[1], kept[1])
        np.testing.assert_array_equal(got1[0], kept[0])
    # another k: another entry
    dq = _single_pair(bench, T(low[0]))[0]
    assert dq.single_call(0, K).fused_entry()[0] != dq.single_call(0, K - 1).fused_entry()[0]
    # another row bucket: two High terms kept sparse (64 and 16 rows)
    keys = []
    for t in (high[16], high[40]):
        q = _single_pair(bench, T(t), knobs=dict(USE_DENSE_TERMS=False))[0]
        keys.append(q.single_call(0, K).fused_entry()[0])
        q.execute_segment(0, K)
    assert keys[0] != keys[1] and all(k in B._FUSED_KINDS["single"] for k in keys)


def test_single_entries_do_not_evict_batch_entries(bench, monkeypatch):
    """Each kind has its own LRU of at most ``_FUSED_CACHE_MAX`` entries: a
    run of distinct single queries fills the "single" LRU and leaves the
    batch's entry in ``_FUSED_CACHE`` (the "batch" LRU);
    ``clear_fused_cache`` empties both."""
    monkeypatch.setattr(B, "_FUSED_CACHE_MAX", 2)
    port, _ref = _batches(bench)
    prep = port.prepare(0, K)
    prep.run_grouped()
    dq = _single_pair(bench, _mix(bench)[0])[0]
    keys = [dq.single_call(0, k).fused_entry()[0] for k in (K, K - 1, K - 2)]
    for k in (K, K - 1, K - 2):
        dq.execute_segment(0, k)
    assert list(B._FUSED_KINDS["single"]) == keys[1:]
    assert list(B._FUSED_CACHE) == [prep._key]
    assert B._FUSED_KINDS["batch"] is B._FUSED_CACHE and not B._FUSED_KINDS["sharded"]
    B.clear_fused_cache()
    assert not B._FUSED_CACHE and not any(B._FUSED_KINDS.values())
