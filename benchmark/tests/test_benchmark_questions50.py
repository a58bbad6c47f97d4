"""The MS MARCO configuration, the ``questions50`` mix and the
``freshbatch`` driver, the one-segment single cell, and the readers of
their metrics, found by name in the spec and run on a tiny index; K4's
byte count against a hand count."""

import json

import pytest
import torch

from benchmark import harness, work_k4
from tiny import run_tiny

CELL = "msmarco-passage.questions50"
SINGLE = "wiki2m-1seg.single"
# the cell's per-layer metrics in the spec's order: the replay cell's
# readers of the fused pass and the device, then the cell's own
NEW_METRICS = ["pass_device_ms.batch", "idle_pct.batch", "fused_run_ms.batch",
               "idle_in_program_pct.batch", "prepare_ms.questions50",
               "fused_hit_pct.questions50", "gridmix_pct.questions50",
               "k4_roofline_pct.questions50"]
SINGLE_METRICS = ["run_ms.single", "idle_pct.single", "prepare_terms_ms.single",
                  "prepare_plan_ms.single", "plan_hit_pct.single", "fused_hit_pct.single",
                  "fused_run_ms.single", "idle_in_program_pct.single"]
# the readers that need a device trace with operations in it
DEVICE_ONLY = {"pass_device_ms.batch", "idle_pct.batch", "idle_in_program_pct.batch",
               "k4_roofline_pct.questions50", "idle_pct.single", "idle_in_program_pct.single"}
# df ranks of the tiny index (4,000 docs) off its dense grid (df >= 32)
SPARSE = {"med": [600, 700], "low": [1000, 2000]}


def _sparse_bands(root):
    path = root / "benchmark" / "traffic" / "questions50.json"
    mix = json.loads(path.read_text())
    mix["bands"].update(SPARSE)
    path.write_text(json.dumps(mix))


def test_the_spec_names_the_new_files():
    spec = harness.load_spec()
    cell = harness.Cell(spec, CELL)
    assert cell.config["name"] == "msmarco-passage" and cell.config["top_k"] == 1000
    assert cell.config["segments"] == [8841823] and cell.config["corpus"]["vocab"] == 2660824
    assert cell.config["scorer"] == {"kind": "bm25", "k1": 0.82, "b": 0.68}
    assert cell.mix["driver"] == "freshbatch" and cell.mix["entry"] == "segment"
    assert cell.mix["batch"] == 50 and not cell.mix["wand"]
    assert {len(c["bands"]) for c in cell.mix["categories"]} == {3, 4, 5, 6}
    assert all(c["op"] == "or" and c["bands"][0] == "high" for c in cell.mix["categories"])
    assert [m["name"] for m in cell.end_to_end] == ["batch_qps", "setup_s"]
    assert [m["name"] for m in cell.per_layer] == NEW_METRICS
    for m in cell.per_layer:
        harness.load_module("layer_metrics", m["name"])
    harness.load_module("drivers", cell.mix["driver"])
    single = harness.Cell(spec, SINGLE)
    assert single.mix["entry"] == "segment" and single.mix["driver"] == "fresh"
    assert [m["name"] for m in single.end_to_end] == ["query_p95_ms", "setup_s"]
    assert [m["name"] for m in single.per_layer] == SINGLE_METRICS
    assert all(w["chips"] == 1 for w in spec["workloads"]) and len(spec["workloads"]) == 4


def test_k4_bytes_by_hand():
    # 3 rows of 10,000 scores, no docs: 120,000 B read; 3 x 100 winners of
    # f32 and an int32 position: 2,400 B written
    assert work_k4.k4_bytes(3, 10_000, 100, 0) == 120_000 + 2_400
    # int32 docs beside the scores: 8 B an entry read, 8 a winner written
    assert work_k4.k4_bytes(2, 4_096, 1_000, 4) == 2 * 4_096 * 8 + 2 * 1_000 * 8
    # int64 docs: 12 B an entry, 12 a winner
    assert work_k4.k4_bytes(1, 2_000, 1_000, 8) == 2_000 * 12 + 1_000 * 12


def test_questions50_on_the_cpu(tiny_root):
    """The fresh batches of the tiny cell against the reference at top
    1,000; a traced run reads the program's metrics, gridmix plans
    counted."""
    _sparse_bands(tiny_root)
    line, _ = run_tiny(tiny_root, CELL)
    assert line["correct"] and line["failed"] == 0 and line["attempted"] > 0, line
    assert set(line["metrics"]) == {"batch_qps", "setup_s"}
    assert line["checks"]["score_err"]["value"] < 1e-5
    # a batch of 50 takes tens of ms here, more on a busy host: two seconds
    # leave the traced slice whole requests
    traced, _ = run_tiny(tiny_root, CELL, trace=True, seconds=2.0)
    assert traced["correct"], traced
    got = traced["metrics"]
    # the CPU's slice holds no device operation: the device's metrics and
    # K4's share are left out
    assert set(got) == set(NEW_METRICS) - DEVICE_ONLY
    assert got["fused_run_ms.batch"]["value"] > 0
    assert got["prepare_ms.questions50"]["value"] > 0
    assert 50 <= got["gridmix_pct.questions50"]["value"] <= 100


def test_questions50_through_the_index_entry(tiny_root):
    """The driver's other entry: fresh batches through ``prepare_all`` over
    the four-segment index, as a later cell may name it."""
    spec = json.loads((tiny_root / "BENCHMARK.json").read_text())
    traffic = tiny_root / "benchmark" / "traffic"
    mix = json.loads((traffic / "questions50.json").read_text())
    mix.update(entry="index", batch=8)
    (traffic / "fresh8.json").write_text(json.dumps(mix))
    cell = {"name": "t.fresh8", "config": "wiki2m-4seg", "traffic": "fresh8", "chips": 1,
            "why": "test"}
    spec["workloads"].append(cell)
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(spec))
    line, _ = run_tiny(tiny_root, cell["name"])
    assert line["correct"] and line["attempted"] > 0, line
    assert set(line["metrics"]) == {"setup_s"}


def test_the_single_readers_hold_for_the_segment_entry(tiny_root, monkeypatch):
    """On the one-segment entry each reader reads its own layer's spans. In
    every request of the slice the query's terms lie under the harness's
    ``prepare``, its plan and its fused pass (kind "single") under ``run``,
    once each, and no span of the batched prepare is there (so
    ``prepare_ms.single`` and the stack and pack readers are not the
    cell's); each reader's value is that of its spans. The device's idle
    shares need a card. Both sides' spans are timed on one host clock, so
    the nesting is checked on it, not on the readers' estimated placement."""
    from benchmark import program_spans, trace
    from iresearch_tpu_torch.utils import timer

    placed, program, harness = [], [], []
    of, take, note_span = program_spans.of, timer.take_spans, trace.Profiler.span

    def keep_placed(ctx):
        placed.append(of(ctx))
        return placed[-1]

    def keep_program():
        program.append(take())
        return program[-1]

    def keep_harness(self, name, a, b):
        harness.append((name, a, b))
        note_span(self, name, a, b)

    monkeypatch.setattr(program_spans, "of", keep_placed)
    monkeypatch.setattr(timer, "take_spans", keep_program)
    monkeypatch.setattr(trace.Profiler, "span", keep_harness)
    line, _ = run_tiny(tiny_root, SINGLE, trace=True, seconds=1.0)
    assert line["correct"], line
    got = {name: m["value"] for name, m in line["metrics"].items()}
    assert set(got) == set(SINGLE_METRICS) - DEVICE_ONLY
    ps, (spans, _dropped) = placed[0], program[0]
    assert ps is not None and ps.requests
    # the profiler's shift of the harness's spans: one constant a run
    shift = ps.harness[0][0][1] - min(a for _name, a, _b in harness)
    under = {"query.terms": "prepare", "query.plan": "run", "fused.run": "run"}
    for req, hspans in zip(ps.requests, ps.harness):
        window = {name: (a, b) for name, a, b in hspans}
        names = [spans[i].name for i in req]
        assert not {"batch.stack", "batch.pack", "merge.init"} & set(names), names
        assert all(names.count(name) == 1 for name in under), names
        for i in req:
            s = spans[i]
            if s.name in under:
                a, b = window[under[s.name]]
                assert a <= s.start_ns * 1e-9 + shift <= s.end_ns * 1e-9 + shift <= b, (s, window)
    assert {s.attrs["kind"] for s in spans if s.name == "fused.run"} == {"single"}
    for name, names in (("prepare_terms_ms.single", ("query.terms",)),
                        ("prepare_plan_ms.single", ("query.plan",)),
                        ("fused_run_ms.single", ("fused.run",))):
        assert got[name] == pytest.approx(ps.median_ms(names)) and got[name] > 0
    assert got["plan_hit_pct.single"] == pytest.approx(ps.hit_pct("query.plan"))
    assert got["fused_hit_pct.single"] == pytest.approx(ps.hit_pct("fused.run"))
    assert 50 <= got["fused_hit_pct.single"] <= 100 and got["run_ms.single"] > 0


def test_the_parent_program_leaves_the_new_counters_out(tiny_root, monkeypatch):
    """A program without ``tier_stats`` and K4's shapes (the parent's) notes
    no counts: the readers report nothing and raise nothing."""
    from iresearch_tpu_torch.exec import batch as B

    _sparse_bands(tiny_root)
    monkeypatch.setattr(B, "note", lambda **attrs: None)
    line, _ = run_tiny(tiny_root, CELL, trace=True, seconds=2.0)
    assert line["correct"], line
    assert "gridmix_pct.questions50" not in line["metrics"]
    assert "k4_roofline_pct.questions50" not in line["metrics"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [CELL, SINGLE])
def test_new_cells_on_the_card(tiny_root, workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _sparse_bands(tiny_root)
    line, _ = run_tiny(tiny_root, workload, trace=True, device="cuda")
    assert line["correct"], line
    assert line["device"]["platform"] == "gpu" and line["device"]["busy_s"] > 0
    names = NEW_METRICS if workload == CELL else SINGLE_METRICS
    assert set(line["metrics"]) == set(names), line["metrics"]
    if workload == CELL:
        assert 0 < line["metrics"]["k4_roofline_pct.questions50"]["value"] <= 100
