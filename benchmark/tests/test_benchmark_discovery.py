"""A later change adds a configuration, a mix and metrics as new files and
new entries of ``BENCHMARK.json``, and edits no file the benchmark has:
the harness finds them all by name and runs the new cell."""

import hashlib
import json

from tiny import run_tiny


def digests(root):
    return {p: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in (root / "benchmark").rglob("*") if p.is_file() and "__pycache__" not in p.parts}


def test_new_files_are_found_by_name(tiny_root):
    before = digests(tiny_root)
    bench = tiny_root / "benchmark"
    cfg = json.loads((bench / "configs" / "wiki2m-4seg.json").read_text())
    cfg.update(name="zipf-two", segments=[2500, 700])
    (bench / "configs" / "zipf-two.json").write_text(json.dumps(cfg))
    mix = json.loads((bench / "traffic" / "single.json").read_text())
    mix.update(categories=mix["categories"][:4])
    (bench / "traffic" / "fresh3.json").write_text(json.dumps(mix))
    (bench / "end_to_end" / "query_p50_ms.py").write_text(
        "import numpy as np\n\n\ndef read(ctx):\n"
        "    return float(np.percentile(ctx.latencies, 50)) * 1e3\n")
    (bench / "layer_metrics" / "prepare_ms.fresh3.py").write_text(
        "import numpy as np\n\n\ndef read(ctx):\n"
        "    s = ctx.spans.get('prepare')\n"
        "    return float(np.median(s)) * 1e3 if s else None\n")
    after_adding = digests(tiny_root)
    assert all(after_adding[p] == h for p, h in before.items())

    spec = json.loads((tiny_root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "zipf-two", "source": "test", "reduced": [], "why": "test",
                            "file": "benchmark/configs/zipf-two.json"})
    cell = "zipf-two.fresh3"
    spec["workloads"].append({"name": cell, "config": "zipf-two", "traffic": "fresh3",
                              "chips": 1, "why": "test"})
    spec["end_to_end"].append({"name": "query_p50_ms", "unit": "ms", "better": "lower",
                               "bound": 0.05, "source": "host_clock", "workloads": [cell]})
    spec["per_layer"].append({"name": "prepare_ms.fresh3", "unit": "ms", "better": "lower",
                              "source": "host_clock", "layer": "prepare",
                              "moves": "query_p50_ms", "workloads": [cell]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(spec))

    line, _ = run_tiny(tiny_root, cell)
    assert line["correct"], line
    assert set(line["metrics"]) == {"query_p50_ms", "setup_s"}
    assert line["metrics"]["query_p50_ms"]["value"] > 0
    traced, _ = run_tiny(tiny_root, cell, trace=True)
    assert traced["correct"] and set(traced["metrics"]) == {"prepare_ms.fresh3"}
    assert (tiny_root / ".bench_cache" / "benchmark" / "zipf-two").is_dir()
