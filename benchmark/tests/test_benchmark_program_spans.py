"""``benchmark/program_spans.py``: the program's spans grouped into the
slice's requests, placed on the profiler's clock by the harness's spans,
and the device's idle time put down to the innermost span; and a traced
tiny run of each cell reporting the metrics that read them."""

import json

import pytest

from benchmark import program_spans as P
from benchmark.trace import Slice
from iresearch_tpu_torch.utils.timer import Span
from tiny import run_tiny

SHIFT = 100.0  # s: the profiler's clock less the host's
LEADS = [1e-6, 3e-6, 1e-6]  # s: each request's harness span opens this much earlier


def _synthetic():
    """Three requests a second apart: ``batch.init`` (``query.terms``
    inside) and ``batch.run`` (``fused.run`` inside, a hit after the
    first); the harness's ``prepare`` and ``run`` on the profiler's clock;
    the device busy 30 ms at each request's start and 100 ms inside its
    run."""
    spans, harness, ops = [], [], []
    ns = lambda t: round(t * 1e9)  # noqa: E731
    for r, lead in enumerate(LEADS):
        t = 10.0 + r
        i = len(spans)
        spans += [Span("batch.init", ns(t + lead), ns(t + 0.1), -1, {}),
                  Span("query.terms", ns(t + lead + 1e-6), ns(t + 0.05), i, {}),
                  Span("batch.run", ns(t + 0.2), ns(t + 0.5), -1, {}),
                  Span("fused.run", ns(t + 0.21), ns(t + 0.49), i + 2,
                       {"kind": "batch", "hit": r > 0, "evicted": 0})]
        harness += [("prepare", t + SHIFT, t + SHIFT + 0.15),
                    ("run", t + SHIFT + 0.19, t + SHIFT + 0.6)]
        ops += [("k", t + SHIFT, t + SHIFT + 0.03), ("k", t + SHIFT + 0.3, t + SHIFT + 0.4)]
    return spans, harness, Slice(ops, harness, 3.0, 3)


def test_shift_requests_and_shares():
    spans, harness, _tr = _synthetic()
    ps = P.place(spans, 0, harness)
    assert ps.shift == pytest.approx(SHIFT - 1e-6, abs=1e-9)
    assert ps.error == pytest.approx(2e-6, abs=1e-9)
    assert ps.requests == [[0, 1, 2, 3], [4, 5, 6, 7], [8, 9, 10, 11]]
    assert [h[0][0] for h in ps.harness] == ["prepare"] * 3
    assert ps.median_ms(("query.terms",)) == pytest.approx(50.0 - 2e-3, abs=1e-6)
    assert ps.median_ms(("batch.init", "batch.run")) == pytest.approx(400.0, abs=1e-2)
    assert ps.hit_pct("fused.run") == pytest.approx(200 / 3)
    assert ps.hit_pct("query.plan") is None


def test_idle_goes_to_the_innermost_span():
    spans, harness, tr = _synthetic()
    ps = P.place(spans, 0, harness)
    idle = ps.idle_by_span(tr.union())
    # each request: query.terms from the first busy end to its own end,
    # batch.init's tail after it, batch.run's 10 ms either side of
    # fused.run, fused.run outside the second busy interval
    want = {"query.terms": 0.02, "batch.init": 0.05, "batch.run": 0.02, "fused.run": 0.18}
    assert set(idle) == set(want)
    for name, s in want.items():
        assert idle[name] == pytest.approx(3 * s, abs=2e-5), name
    objects = {}
    ctx = type("Ctx", (), dict(objects=objects, trace=tr, log=print))()
    objects[P.KEY] = ps
    assert P.idle_in_program_pct(ctx) == pytest.approx(100 * 3 * 0.27 / 3.0, abs=1e-3)


def test_unpaired_and_empty():
    spans, harness, _tr = _synthetic()
    assert P.place([], 0, harness) is None and P.place(spans, 0, []) is None
    ps = P.place(spans, 5, harness[:4])  # the harness saw two requests
    assert len(ps.requests) == 2 and ps.dropped == 5


NEW = {"wiki2m-4seg.single": ["prepare_terms_ms.single", "prepare_plan_ms.single",
                              "prepare_stack_ms.single", "prepare_pack_ms.single",
                              "plan_hit_pct.single", "fused_hit_pct.single",
                              "fused_run_ms.single"],
       "wiki2m-1seg.replay400": ["fused_run_ms.batch"]}
IDLE = {"wiki2m-4seg.single": "idle_in_program_pct.single",
        "wiki2m-1seg.replay400": "idle_in_program_pct.batch"}


@pytest.mark.parametrize("workload", sorted(NEW))
def test_traced_tiny_run_reports_the_program_metrics(tiny_root, workload):
    """On the CPU the slice holds no device operation, so the idle share
    under program spans is left out; every other new metric is read."""
    spec = json.loads((tiny_root / "BENCHMARK.json").read_text())
    assert all(workload in m["workloads"] for m in spec["per_layer"]
               if m["name"] in NEW[workload] + [IDLE[workload]])
    line, _ = run_tiny(tiny_root, workload, trace=True, seconds=1.0)
    assert line["correct"], line
    for name in NEW[workload]:
        value = line["metrics"][name]["value"]
        assert value > 0 if name.startswith("fused_run_ms") else value >= 0, name
    assert IDLE[workload] not in line["metrics"]
