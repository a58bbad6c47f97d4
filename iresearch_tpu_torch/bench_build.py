"""Index-build throughput of the port: the counterpart of the repo's
``bench_build.py`` (reference: index-put, 8 indexer threads over the
wikipedia line dump, utils/index-put.cpp:359-640; canonical run
scripts/index-benchmark.sh).

Builds the synthetic text corpus of ``bench_build.py`` (seed 7) and
measures docs/s through the port's ``IndexWriter`` (analyzer, native term
dict, inversion, block encode, commit) with ``BUILD_THREADS`` indexer
threads, each inserting batches of 50 docs, and a committer thread, the
reference's thread topology. The writer inverts on the host
(``invert_backend="numpy"``), so the measured pipeline is the JAX
package's; ``index/invert.py:invert_device`` is measured apart. Logs docs/s,
tokens/s and the share of the time the writer's register lock was held,
with the card's name and power limit; prints one JSON line. Without a card
it fails at once.

Run: ``python -m iresearch_tpu_torch.bench_build`` (env ``BUILD_DOCS``,
default 20,000; ``BUILD_THREADS``, default 4).
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from typing import List, NamedTuple, Tuple

import numpy as np

VOCAB = 30_000
BATCH = 50


class Result(NamedTuple):
    """``line`` is the printed object; ``reader`` the built index, opened
    on the run's device."""

    line: dict
    reader: object


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def corpus(num_docs: int) -> Tuple[List[str], int]:
    """(docs, tokens): ``bench_build.py``'s text corpus, doc lengths uniform
    in [40, 120), words ``t%06d`` of Zipf(1.25) ranks clipped to VOCAB,
    seed 7."""
    rng = np.random.default_rng(7)
    words = [f"t{i:06d}" for i in range(VOCAB)]
    lens = rng.integers(40, 120, size=num_docs)
    total = int(lens.sum())
    tids = np.minimum(rng.zipf(1.25, size=total) - 1, VOCAB - 1)
    docs = []
    off = 0
    for n in lens:
        docs.append(" ".join(words[t] for t in tids[off : off + n]))
        off += n
    return docs, total


def run(num_docs: int = 20_000, threads: int = 4, *, device=None, log=log) -> Result:
    """Index ``num_docs`` docs of the corpus with ``threads`` indexer
    threads into a ``MemoryDirectory`` on ``device`` (the card when None;
    raises without one); raises unless every doc is live in the index."""
    from iresearch_tpu_torch.bench import card_label
    from iresearch_tpu_torch.exec.executor import entry_device
    from iresearch_tpu_torch.index.reader import DirectoryReader
    from iresearch_tpu_torch.index.writer import Field, IndexWriter, IndexWriterOptions
    from iresearch_tpu_torch.store.directory import MemoryDirectory

    dev = entry_device(device)
    name, watts, card = card_label(dev)
    t0 = time.time()
    docs, total = corpus(num_docs)
    log(f"corpus: {num_docs} docs, {total} tokens ({time.time() - t0:.1f}s)")

    d = MemoryDirectory()
    opts = IndexWriterOptions(invert_backend="numpy", segment_docs_max=1 << 20)
    t1 = time.time()
    with IndexWriter(d, opts, device=dev) as w:
        stop = threading.Event()

        def committer():
            # periodic commit (reference: a commit thread every 10 s; scaled)
            while not stop.wait(2.0):
                w.commit()

        ct = threading.Thread(target=committer, daemon=True)
        ct.start()
        nxt = [0]
        lock = threading.Lock()

        def indexer():
            while True:
                with lock:
                    i = nxt[0]
                    if i >= num_docs:
                        return
                    nxt[0] = i + BATCH
                with w.batch() as tx:
                    for j in range(i, min(i + BATCH, num_docs)):
                        tx.insert([
                            Field("body", docs[j], analyzer="segmentation"),
                            Field("id", str(j), index=True, store=True),
                        ])

        workers = [threading.Thread(target=indexer) for _ in range(threads)]
        for t in workers:
            t.start()
        for t in workers:
            t.join()
        stop.set()
        ct.join()
        w.commit()
        reg_s = w.stats["register_held_s"]
    build_s = time.time() - t1
    r = DirectoryReader.open(d, device=dev)
    if r.live_docs_count != num_docs:
        raise AssertionError(f"{r.live_docs_count} live docs, {num_docs} indexed")
    dps = num_docs / build_s
    log(f"indexed {num_docs} docs / {total} tokens in {build_s:.4f}s with {threads} indexer "
        f"threads -> {dps:.1f} docs/s ({total / build_s / 1e6:.4f}M tokens/s), "
        f"{len(r.segments)} segment(s) on {card}")
    # the serial share: the register step runs under the writer's lock
    s_frac = reg_s / build_s if build_s else 0.0
    log(f"mutex-held (register) time {reg_s:.4f}s = {100 * s_frac:.2f}% of wall; Amdahl bound "
        f"for the serialized register step: {1.0 / (s_frac + (1 - s_frac) / 4):.2f}x @4 threads, "
        f"{1.0 / (s_frac + (1 - s_frac) / 8):.2f}x @8 threads")
    line = {
        "metric": "index_build_docs_per_sec", "value": dps, "unit": "docs/sec",
        "device": name, "power_limit_w": watts, "docs": num_docs, "tokens": total,
        "threads": threads, "register_held_share": s_frac,
    }
    return Result(line, r)


def main() -> int:
    from iresearch_tpu_torch.device import require_cuda

    try:
        dev = require_cuda()
    except RuntimeError as e:
        log(f"bench_build: {e}")
        return 1
    res = run(int(os.environ.get("BUILD_DOCS", 20_000)),
              int(os.environ.get("BUILD_THREADS", 4)), device=dev)
    print(json.dumps(res.line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
