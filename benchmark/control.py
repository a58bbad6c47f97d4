"""The control of ``correct``: the reference put in the program's place
and computed a precision lower than the configuration states (bfloat16
for its float32 scores), judged by the same comparison as a run.

It serves the queries a run of the cell judges: the fixed set of a
``replay`` mix, or ``check_sample`` requests of a ``fresh`` mix's window
stream, at the cell's sizes. Its numbers have to fail a limit of
``checks.LIMITS``; ``PERF.md`` gives its readings beside the program's.
The benchmark's own runs never run it.

Run on the card: ``python -m benchmark.control --workload <cell> --seeds
<n> <n> ...``; one JSON line a seed.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

from benchmark import checks
from benchmark import corpus as C
from benchmark import harness
from benchmark.traffic import QueryStream, band_terms, fixed_mix


def queries_of(mix: dict, bands, seed: int):
    if mix["driver"] == "replay":
        return fixed_mix(mix, bands)
    return QueryStream(mix, bands, seed, "window").draw(int(mix["check_sample"]))


def control_numbers(cell: harness.Cell, seed: int, device, root: Path = harness.ROOT,
                    dtype=torch.bfloat16) -> dict:
    """The compared numbers of the reference in ``dtype`` in the program's
    place, for one seed."""
    cfg, mix = cell.config, cell.mix
    corpus = C.generate(cfg["corpus"], cfg["segments"], seed, device)
    bands = band_terms(mix, C.ranked_terms(C.doc_freqs(corpus)))
    refmod = harness.load_module("references", cfg["reference"], root)
    ref, low = refmod.make(corpus, cfg), refmod.make(corpus, cfg, dtype)
    k = int(cfg["top_k"])
    answers = []
    for q in queries_of(mix, bands, seed):
        docs, sc = low.evaluate(q).top(k)
        v = np.full(k, -np.inf, np.float32)
        d = np.full(k, -1, np.int64)
        v[: len(sc)] = sc.float().cpu().numpy()
        d[: len(docs)] = docs.cpu().numpy()
        answers.append((q, v, d))
    return checks.judge(answers, ref, k)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m benchmark.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    cell = harness.Cell(harness.load_spec(), args.workload)
    for seed in args.seeds:
        numbers = control_numbers(cell, seed, torch.device("cuda", 0))
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": checks.passed(numbers), "numbers": numbers}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
