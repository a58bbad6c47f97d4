"""One run of one cell: ``python -m benchmark.run --workload <cell> --seed
<n> --seconds <s> --trace <0|1>`` from the root of a checkout.

Prints one JSON line on stdout (``correct``, ``attempted``, ``failed``,
``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``: each compared number with its limit), and those numbers again
as the last lines of stderr. Exits 2 and prints no line where CUDA is not
available or the card has fewer devices than the cell asks for, and 1
where a module of ``jax``, ``jaxlib``, ``flax`` or the JAX package
``iresearch_tpu`` was loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m benchmark.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    import torch

    from benchmark import harness

    spec = harness.load_spec()
    chips = harness.Cell(spec, args.workload).cell["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"benchmark: the cell needs {chips} CUDA device(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available")
        return 2
    line, checks = harness.run_cell(spec, args.workload, args.seed, args.seconds,
                                    bool(args.trace), torch.device("cuda", 0), T0, log)
    if line is None:
        return 1
    print(json.dumps(line), flush=True)
    for c in checks:
        log(c)
    return 0


if __name__ == "__main__":
    sys.exit(main())
