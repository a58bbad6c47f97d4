"""A tiny checkout for the benchmark's CPU tests: ``BENCHMARK.json`` and a
copy of ``benchmark/`` whose configurations and mixes are cut to a few
thousand docs, so that a whole run takes seconds on the CPU.

Run from the repo root: ``python -m pytest benchmark/tests -q``.
"""

import json
import shutil
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
SEED = 2**31 + 12345  # past 32 signed bits, as a run's seed may be
BANDS = {"high": [2, 12], "med": [40, 50], "low": [300, 310]}


def shrink(root: Path) -> dict:
    """Cut ``root``'s configurations and mixes in place; returns the spec."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    for c in spec["configs"]:
        path = root / c["file"]
        cfg = json.loads(path.read_text())
        cfg["segments"] = [4000] if len(cfg["segments"]) == 1 else [4000, 1500, 300, 60]
        cfg["corpus"].update(vocab=3000, doc_len=[16, 48])
        path.write_text(json.dumps(cfg))
    for path in (root / "benchmark" / "traffic").glob("*.json"):
        mix = json.loads(path.read_text())
        mix["bands"] = BANDS
        mix["warmup_requests"] = 2
        if "per_category" in mix:
            mix["per_category"] = 10
        if "check_sample" in mix:
            mix["check_sample"] = 24
        path.write_text(json.dumps(mix))
    return spec


def log(*a):
    print(*a, file=sys.stderr)


def run_tiny(root: Path, workload: str, trace: bool = False, seed: int = SEED,
             seconds: float = 0.5, device: str = "cpu"):
    from benchmark import harness

    spec = json.loads((root / "BENCHMARK.json").read_text())
    return harness.run_cell(spec, workload, seed, seconds, trace, device,
                            time.perf_counter(), log, root=root)


def make_tiny(tmp_path: Path) -> Path:
    shutil.copytree(REPO / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shrink(tmp_path)
    return tmp_path
