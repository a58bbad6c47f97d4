"""Whole runs of every cell on a tiny index: the program against the
reference through each driver and entry point, the result line's keys,
and the run's refusals (no card, no program, a forbidden module)."""

import json
import os
import subprocess
import sys
import types

import pytest
import torch

from tiny import REPO, run_tiny

CELLS = ["wiki2m-1seg.replay400", "wiki2m-4seg.single"]


def check_line(line, trace):
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert ("breakdown" in line) == trace
    dev = line["device"]
    for key in ("platform", "kind", "count", "memory_peak_bytes"):
        assert key in dev
    for name, c in line["checks"].items():
        assert set(c) == {"value", "limit"}, name
    for name, m in line["metrics"].items():
        assert set(m) == {"value", "unit"}, name
    json.dumps(line)


@pytest.mark.parametrize("workload", CELLS)
def test_cell_on_the_cpu(tiny_root, workload):
    line, lines = run_tiny(tiny_root, workload)
    check_line(line, False)
    assert line["correct"] and line["failed"] == 0 and line["attempted"] > 0, line
    assert line["checks"]["score_err"]["value"] < 1e-5
    spec = json.loads((tiny_root / "BENCHMARK.json").read_text())
    want = {m["name"] for m in spec["end_to_end"] if workload in m.get("workloads", [workload])}
    assert set(line["metrics"]) == want
    assert lines[-1].startswith("check ") and len(lines) == len(line["checks"])
    # the second run of the seed opens the cached segments
    cache = tiny_root / ".bench_cache" / "benchmark"
    assert len(list(cache.glob("*/*/seg*.bin"))) >= 1
    line2, _ = run_tiny(tiny_root, workload, trace=True)
    check_line(line2, True)
    assert line2["correct"]
    assert line2["checks"] == line["checks"] or workload.endswith("single")


def test_other_entries(tiny_root):
    """The fresh driver's other entry point, as a later mix may name it:
    one query through ``DeviceQuery`` on a one-segment index."""
    spec = json.loads((tiny_root / "BENCHMARK.json").read_text())
    traffic = tiny_root / "benchmark" / "traffic"
    mix = json.loads((traffic / "single.json").read_text())
    cell = {"name": "t.single", "config": "wiki2m-1seg", "traffic": "t_single", "chips": 1}
    mix["entry"] = "segment"
    (traffic / f"{cell['traffic']}.json").write_text(json.dumps(mix))
    spec["workloads"].append(dict(cell, why="test"))
    spec["end_to_end"][-1].pop("workloads", None)
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(spec))
    line, _ = run_tiny(tiny_root, cell["name"])
    assert line["correct"], line
    assert "setup_s" in line["metrics"]


def test_a_cache_keeps_only_the_current_seed(tiny_root):
    run_tiny(tiny_root, CELLS[0], seed=11)
    run_tiny(tiny_root, CELLS[0], seed=12)
    seeds = [p.name for p in (tiny_root / ".bench_cache" / "benchmark" / "wiki2m-1seg").iterdir()]
    assert seeds == ["12"]


def test_a_forbidden_module_refuses_the_run(tiny_root, monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    line, lines = run_tiny(tiny_root, CELLS[0])
    assert line is None and lines == []


def test_without_a_card_the_command_prints_no_line():
    r = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", CELLS[0], "--seed", "1",
         "--seconds", "1", "--trace", "0"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""),
    )
    assert r.returncode != 0 and r.stdout == ""
    assert "CUDA" in r.stderr


def test_without_the_program_the_run_fails(tiny_root):
    """A checkout of only ``BENCHMARK.json`` and ``benchmark/``: the
    program cannot be imported, so the run raises and prints no line."""
    code = ("import sys, time; from benchmark import harness; "
            "harness.run_cell(harness.load_spec(), sys.argv[1], 3, 0.5, False, 'cpu', "
            "time.perf_counter(), print)")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code, CELLS[0]], cwd=tiny_root,
                       capture_output=True, text=True, timeout=300, env=env)
    assert r.returncode != 0 and "iresearch_tpu_torch" in r.stderr


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_cell_on_the_card(tiny_root, workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    line, _ = run_tiny(tiny_root, workload, trace=True, device="cuda")
    assert line["correct"], line
    assert line["device"]["platform"] == "gpu" and line["device"]["busy_s"] > 0
