"""Multithreaded line-doc indexer (reference: utils/index-put.cpp:359-640).

Pipeline mirrors the reference: a reader thread batches lines from the
input file; N indexer threads run transactions against one IndexWriter; a
committer thread commits on a period; optional consolidation thread runs
tiered consolidation. Line format is the luceneutil wiki dump:
``title<TAB>date<TAB>body`` (fields id/title/date(+stored)/body,
index-put.cpp:271-350). ``--invert auto|device`` inverts each flush on
``--device`` (the card unless named), ``numpy`` on the host.
"""

from __future__ import annotations

import argparse
import queue
import sys
import threading
import time
from typing import List, Optional

from iresearch_tpu_torch.index.writer import Field, IndexWriter, IndexWriterOptions
from iresearch_tpu_torch.store.directory import FSDirectory
from iresearch_tpu_torch.utils.timer import registry as timer_registry


def parse_args(argv):
    p = argparse.ArgumentParser(prog="index_put")
    p.add_argument("--in", dest="input", required=True, help="line-docs file")
    p.add_argument("--index-dir", required=True)
    p.add_argument("--max-lines", type=int, default=-1)
    p.add_argument("--threads", type=int, default=1, help="indexer threads")
    p.add_argument("--batch-size", type=int, default=10000)
    p.add_argument("--commit-period", type=int, default=0, help="ms; 0 = only final")
    p.add_argument("--consolidate", action="store_true", help="tiered consolidation at end")
    p.add_argument("--analyzer", default="segmentation")
    p.add_argument(
        "--invert", default="auto", choices=["auto", "numpy", "device"],
        help="inversion backend (device = the segment sort on --device)",
    )
    p.add_argument("--device", default=None, help="torch device (default: the card)")
    p.add_argument("--segment-docs-max", type=int, default=1 << 17)
    p.add_argument("--metrics-out", default=None)
    return p.parse_args(argv)


def doc_fields(line: str, seq: int, analyzer: str) -> Optional[List[Field]]:
    parts = line.rstrip("\n").split("\t", 2)
    if len(parts) < 3:
        if not line.strip():
            return None
        title, date, body = line.strip()[:64], "", line
    else:
        title, date, body = parts
    return [
        Field("id", str(seq), analyzer="identity", index=True, store=True),
        Field("title", title, analyzer="identity", index=True, store=True),
        Field("date", date, analyzer="identity", index=True, store=True),
        Field("body", body, analyzer=analyzer),
    ]


def main(argv) -> int:
    args = parse_args(argv)
    t0 = time.time()
    d = FSDirectory(args.index_dir)
    opts = IndexWriterOptions(
        invert_backend=args.invert, segment_docs_max=args.segment_docs_max
    )
    total = 0
    stop = threading.Event()
    q: "queue.Queue" = queue.Queue(maxsize=64)

    with IndexWriter(d, opts, device=args.device) as w:
        committer = None
        if args.commit_period > 0:
            def commit_loop():
                while not stop.wait(args.commit_period / 1000.0):
                    w.commit()
            committer = threading.Thread(target=commit_loop, daemon=True)
            committer.start()

        # named indexer pool + wait group (reference: async_utils::
        # ThreadPool + wait_group, utils/index-put.cpp:456-560)
        from iresearch_tpu_torch.utils.pools import ThreadPool, WaitGroup

        pool = ThreadPool(max(1, args.threads), name="index-put")
        wg = WaitGroup()

        def indexer():
            while True:
                item = q.get()
                if item is None:
                    return
                with w.batch() as tx:
                    for seq, line in item:
                        f = doc_fields(line, seq, args.analyzer)
                        if f is not None:
                            tx.insert(f)

        workers = []
        for _ in range(max(1, args.threads)):
            pool.submit(indexer, wg)
            workers.append(None)

        batch: List = []
        with open(args.input, "r", encoding="utf-8", errors="replace") as fh:
            for seq, line in enumerate(fh):
                if 0 <= args.max_lines <= seq:
                    break
                batch.append((seq, line))
                total += 1
                if len(batch) >= args.batch_size:
                    q.put(batch)
                    batch = []
        if batch:
            q.put(batch)
        for _ in workers:
            q.put(None)
        wg.wait()
        pool.stop()
        stop.set()
        if committer is not None:
            committer.join()
        w.commit()
        if args.consolidate:
            w.consolidate()
            w.commit()
    dt = time.time() - t0
    print(f"Indexed {total} docs in {dt:.2f}s ({total/max(dt,1e-9):.0f} docs/s)")
    if args.metrics_out:
        from iresearch_tpu_torch.utils.metrics import registry

        m = registry()
        m.gauge("Wall_Clock", dt, {"mode": "put"}, help_="wall clock (s)")
        m.gauge("Docs_Per_Second", total / max(dt, 1e-9), {"mode": "put"})
        m.write(args.metrics_out)
    for name, (count, ns) in sorted(timer_registry().flush_stats().items()):
        print(f"  timer {name}: {count} calls, {ns/1e6:.1f} ms", file=sys.stderr)
    return 0
