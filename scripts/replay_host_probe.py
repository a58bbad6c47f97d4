"""The host's side of the replay400 pass with the profiler off and on.

The program's spans (``utils/timer.py``) are recorded only under a
``torch.profiler`` session, whose CUPTI tracing makes each CUDA call
dearer. This times the same calls with plain host clocks in turns,
profiler off, on, on, off: the median ms to ``run_grouped()``'s return,
to the device's end of the pass, and to ``graph.replay()``'s return
alone, over 60 requests a turn.

On a card, from the repo root, after a benchmark run of the cell with
the same seed (which leaves its index in ``.bench_cache/``):

    python3 scripts/replay_host_probe.py SEED
"""

from __future__ import annotations

import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
from torch.profiler import profile  # noqa: E402

from benchmark import corpus as C  # noqa: E402
from benchmark import harness, program  # noqa: E402
from benchmark import trace as T  # noqa: E402
from benchmark.traffic import band_terms  # noqa: E402
from iresearch_tpu_torch.exec import batch as B  # noqa: E402

CELL = "wiki2m-1seg.replay400"
REQUESTS = 60


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def main(seed: int) -> None:
    cell = harness.Cell(harness.load_spec(), CELL)
    dev = torch.device("cuda", 0)
    ctx = harness.Context(cell, seed, dev, log)
    corpus = C.generate(cell.config["corpus"], cell.config["segments"], seed, dev)
    ctx.bands = band_terms(cell.mix, C.ranked_terms(C.doc_freqs(corpus)))
    ctx.segments, _ = program.open_index(
        harness.ROOT / ".bench_cache" / "benchmark" / cell.config["name"], corpus, seed, dev, log)
    del corpus
    state = harness.load_module("drivers", cell.mix["driver"]).setup(ctx)
    entry = B._FUSED_CACHE[state.prep._key]
    print(f"{torch.cuda.get_device_name(dev)}; graph nodes {entry.nodes}, "
          f"launches a replay {entry.launches}", flush=True)
    T.warm_profiler(lambda: (torch.ones(1, device=dev) + 1, torch.cuda.synchronize()), dev)

    def turn():
        call, done, replay = [], [], []
        for _ in range(REQUESTS):
            t0 = time.perf_counter()
            state.prep.run_grouped()
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            entry.graph.replay()
            t3 = time.perf_counter()
            torch.cuda.synchronize()
            call.append(t1 - t0)
            done.append(t2 - t0)
            replay.append(t3 - t2)
        return [1e3 * statistics.median(x) for x in (call, done, replay)]

    for on in (False, True, True, False):
        if on:
            with profile(activities=T.activities(dev)):
                got = turn()
        else:
            got = turn()
        print(f"profiler {'on' if on else 'off'}: run_grouped host ms {got[0]:.4f}, to the "
              f"device's end {got[1]:.4f}, graph.replay() host ms {got[2]:.4f}", flush=True)


if __name__ == "__main__":
    main(int(sys.argv[1]))
