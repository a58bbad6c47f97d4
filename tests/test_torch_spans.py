"""The query path's spans and cache counters (``utils/timer.py:span``,
``exec/plancache.py:plan_cache_stats``, ``exec/batch.py:fused_cache_stats``)
on the CPU, over a two-segment index of the bench law built by the port.

Spans are recorded only inside a ``torch.profiler`` session; the results
of a run do not depend on it. Each span's parent is the span open on its
thread when it began, and it lies inside its parent."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from iresearch_tpu_torch import bench_mix  # noqa: E402
from iresearch_tpu_torch.exec import batch as B  # noqa: E402
from iresearch_tpu_torch.exec import plancache  # noqa: E402
from iresearch_tpu_torch.exec.batch import QueryBatch  # noqa: E402
from iresearch_tpu_torch.exec.executor import DeviceQuery  # noqa: E402
from iresearch_tpu_torch.index.segment import SegmentReader  # noqa: E402
from iresearch_tpu_torch.search import filters as F  # noqa: E402
from iresearch_tpu_torch.search.scorers import BM25  # noqa: E402
from iresearch_tpu_torch.utils import timer  # noqa: E402

K = 10


@pytest.fixture(scope="module")
def segs():
    return [SegmentReader("spans0", bench_mix.build_segment_data(2000, bench_mix.SEED)),
            SegmentReader("spans1", bench_mix.build_segment_data(500, bench_mix.SEED + 1))]


@pytest.fixture(autouse=True)
def empty_caches():
    B.clear_fused_cache()
    plancache.clear_plan_cache()
    timer.take_spans()
    yield
    B.clear_fused_cache()
    plancache.clear_plan_cache()
    timer.take_spans()


def _filters(segs, n=3):
    return [f for _c, f in bench_mix.task_mix(segs[0])[::40]][:n]


def _served(filters, segs):
    return QueryBatch(filters, segs, BM25(), device="cpu").prepare_all(K).run()


def _traced(fn):
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    return out, timer.take_spans()


def _tree(spans):
    """[(depth, name)] in start order; each child inside its parent."""
    out = []
    for s in spans:
        depth, p = 0, s.parent
        if p >= 0:
            parent = spans[p]
            assert parent.start_ns <= s.start_ns <= s.end_ns <= parent.end_ns, (parent, s)
        while p >= 0:
            depth, p = depth + 1, spans[p].parent
        out.append((depth, s.name))
    return out


def test_no_span_without_a_profiler_and_the_same_results(segs):
    """Without a profiler a served batch records nothing; under a CPU
    profiler session it records spans and returns the same bits."""
    filters = _filters(segs)
    vals, docs = _served(filters, segs)
    assert timer.take_spans() == ([], 0)
    (tv, td), (spans, dropped) = _traced(lambda: _served(filters, segs))
    assert spans and dropped == 0
    assert torch.equal(tv, vals) and torch.equal(td, docs)


def test_span_names_parents_and_nesting(segs):
    """The index pass's spans nest as documented: a miss captures, a
    fresh batch of the same structure loads and replays; the single query
    plans under ``query.plan`` and replays under ``batch.run``."""
    filters = _filters(segs, 2)
    _out, (first, _) = _traced(lambda: _served(filters, segs))
    prepare = [(1, "query.plan")] * 2 + [(1, "batch.stack"), (1, "batch.pack")]
    head = [(0, "batch.init")] + [(1, "query.terms")] * 2
    for seg in range(2):
        head += [(0, "batch.prepare")] + prepare
    head += [(0, "merge.init"), (0, "batch.run"), (1, "fused.run")]
    assert _tree(first) == head + [(2, "fused.capture"), (2, "fused.replay")]
    assert [s.attrs["seg"] for s in first if s.name == "batch.prepare"] == [0, 1]
    run = next(s for s in first if s.name == "fused.run")
    assert run.attrs == {"kind": "batch", "hit": False, "evicted": 0}
    assert all("hit" in s.attrs for s in first if s.name == "query.plan")

    _out, (again, _) = _traced(lambda: _served(filters, segs))
    assert _tree(again) == head + [(2, "fused.load"), (2, "fused.replay")]
    assert next(s for s in again if s.name == "fused.run").attrs["hit"] is True
    assert all(s.attrs["hit"] for s in again if s.name == "query.plan")

    dq = DeviceQuery(filters[0], segs, BM25(), device="cpu")
    _out, (single, _) = _traced(lambda: dq.execute_segment_async(0, K))
    assert _tree(single) == [(0, "query.plan"), (0, "batch.run"), (1, "fused.run"),
                             (2, "fused.capture"), (2, "fused.replay")]
    assert next(s for s in single if s.name == "fused.run").attrs["kind"] == "single"


def test_hit_attributes_equal_the_counters(segs):
    """The ``hit`` attributes of ``query.plan`` and ``fused.run`` agree
    with the deltas of ``plan_cache_stats()`` and ``fused_cache_stats()``."""
    filters = _filters(segs, 4)
    plans0, fused0 = plancache.plan_cache_stats(), B.fused_cache_stats()["batch"]

    def serve():
        for fs in (filters[:2], filters[2:], filters[:2], filters[:1]):
            _served(fs, segs)

    _out, (spans, _) = _traced(serve)
    plans1, fused1 = plancache.plan_cache_stats(), B.fused_cache_stats()["batch"]
    for name, now, before in (("query.plan", plans1, plans0), ("fused.run", fused1, fused0)):
        hits = [s.attrs["hit"] for s in spans if s.name == name]
        assert sum(hits) == now["hits"] - before["hits"] > 0, name
        assert hits.count(False) == now["misses"] - before["misses"] > 0, name
    assert plans1["evictions"] == plans0["evictions"]
    assert fused1["evictions"] == fused0["evictions"]


def test_tier_counts_equal_the_stack_attributes(segs):
    """Each ``batch.stack`` span carries its prepare's counts by exec mode
    and tier, and their sums are the deltas of ``tier_stats()``; every
    query and group is counted once in each."""
    filters = _filters(segs, 6)
    before = B.tier_stats()
    _out, (spans, _) = _traced(lambda: [_served(filters, segs),
                                        QueryBatch(filters, segs, BM25(), device="cpu")
                                        .prepare(0, 200)])
    after = B.tier_stats()
    stacks = [s.attrs for s in spans if s.name == "batch.stack"]
    assert len(stacks) == 3 == after["prepares"] - before["prepares"]
    for key in B._TIER_KEYS:
        want = {m: n - before[key].get(m, 0) for m, n in after[key].items()
                if n != before[key].get(m, 0)}
        got = {}
        for attrs in stacks:
            for m, n in attrs[key].items():
                got[m] = got.get(m, 0) + n
        assert got == want, key
    assert after["past_k_max"] - before["past_k_max"] == sum(a["past_k_max"] for a in stacks)
    for attrs in stacks:
        assert sum(attrs["mode_queries"].values()) == sum(attrs["tier_queries"].values())
        assert sum(attrs["mode_groups"].values()) == sum(attrs["tier_groups"].values())
    # top 200 turns the single dense terms' groups away from the skyline
    assert stacks[-1]["past_k_max"] > 0 and "skyline" not in stacks[-1]["tier_groups"]
    assert sum(stacks[0]["mode_queries"].values()) == len(filters)


def test_k4_shapes_on_the_replay_equal_the_calls(segs, monkeypatch):
    """A fused pass notes on ``fused.replay`` the (Q, N, k, doc bytes) of
    every ``topk_docs`` call that it ran, in order: the calls that a
    spy on the kernel set sees."""
    seen = []
    topk = B.KERNELS.topk

    def spy(scores, docs, k):
        n = scores.shape[-1]
        seen.append((scores.numel() // n, n, k, 0 if docs is None else docs.element_size()))
        return topk(scores, docs, k)

    monkeypatch.setattr(B, "KERNELS", B.KERNELS._replace(topk=spy))
    prep = QueryBatch(_filters(segs, 6), segs, BM25(), device="cpu").prepare(0, 50)
    _out, (spans, _) = _traced(prep.run_grouped)
    (replay,) = [s for s in spans if s.name == "fused.replay"]
    assert seen and replay.attrs["k4"] == tuple(seen)
    assert all(q >= 1 and n >= k for q, n, k, _b in seen) and {b for *_x, b in seen} <= {0, 4, 8}


def test_plan_cache_counts_evictions_and_plans_not_stored(segs, monkeypatch):
    """Past ``_CACHE_MAX`` the oldest plans are evicted and counted; a plan
    over ``_ROW_LIMIT`` rows is compiled, not stored, and counted."""
    monkeypatch.setattr(plancache, "_CACHE_MAX", 2)
    terms = [F.ByTerm("body", t) for t in ("t000002", "t000003", "t000004", "t000005")]
    before = plancache.plan_cache_stats()
    for f in terms + terms[-1:]:
        DeviceQuery(f, segs, BM25(), device="cpu").plan(0)
    after = plancache.plan_cache_stats()
    assert plancache.plan_cache_info() == (2, 2)
    assert {k: after[k] - before[k] for k in after} == {
        "hits": 1, "misses": 4, "evictions": 2, "not_stored": 0}
    monkeypatch.setattr(plancache, "_ROW_LIMIT", -1)
    DeviceQuery(terms[0], segs, BM25(), device="cpu").plan(0)
    final = plancache.plan_cache_stats()
    assert final["misses"] - after["misses"] == 1 and final["not_stored"] - after["not_stored"] == 1
    assert plancache.plan_cache_info() == (2, 2)


def test_spans_past_the_bound_are_dropped_and_counted():
    rec = timer.SpanRecorder(capacity=3)
    with profile(activities=[ProfilerActivity.CPU]):
        with rec.span("a", n=1):
            for _ in range(4):
                with rec.span("b"):
                    rec.note(hit=True)
    spans, dropped = rec.take()
    assert [(s.name, s.parent, s.attrs) for s in spans] == [
        ("a", -1, {"n": 1}), ("b", 0, {"hit": True}), ("b", 0, {"hit": True})]
    assert dropped == 2 and rec.take() == ([], 0)
    assert np.all([s.end_ns >= s.start_ns > 0 for s in spans])


def test_threads_nest_their_own_spans():
    """Threads that open spans at once (more threads than cores, a short
    switch interval) each nest under their own open span; none is lost."""
    import sys
    import threading

    rec, n, per = timer.SpanRecorder(), 16, 200

    def work(t):
        for i in range(per):
            with rec.span("outer", t=t):
                with rec.span("inner", t=t):
                    rec.note(i=i)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            threads = [threading.Thread(target=work, args=(t,)) for t in range(n)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    spans, dropped = rec.take()
    assert dropped == 0 and len(spans) == 2 * n * per
    for s in spans:
        if s.name == "inner":
            parent = spans[s.parent]
            assert parent.name == "outer" and parent.attrs["t"] == s.attrs["t"]
        else:
            assert s.parent == -1 and "i" not in s.attrs
