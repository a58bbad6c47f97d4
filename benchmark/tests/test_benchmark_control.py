"""The control (the reference in bfloat16 in the program's place) has to
come out not ``correct`` at a size a test run holds, on three seeds; on
the card it runs at the cells' own sizes (``python -m benchmark.control``)."""

import json

import pytest

from benchmark import checks, control, harness
from tiny import make_tiny


@pytest.mark.parametrize("workload", ["wiki2m-1seg.replay400", "wiki2m-4seg.single"])
def test_control_is_not_correct(tmp_path, workload):
    root = make_tiny(tmp_path)
    # larger than the tiny runs' index, so that bfloat16's ties show
    for c in ("wiki2m-1seg", "wiki2m-4seg"):
        path = root / "benchmark" / "configs" / f"{c}.json"
        cfg = json.loads(path.read_text())
        cfg["segments"] = [s * 5 for s in cfg["segments"]]
        path.write_text(json.dumps(cfg))
    cell = harness.Cell(harness.load_spec(root), workload, root)
    for seed in (1, 2, 2**31 + 3):
        numbers = control.control_numbers(cell, seed, "cpu", root)
        assert not checks.passed(numbers), numbers
        assert numbers["score_err"] > checks.LIMITS["score_err"]
