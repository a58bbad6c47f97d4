"""Microbenchmarks of the port: the counterpart of the repo's
``bench_micro.py`` (reference analog: microbench/ google-benchmark suite:
column writer, crc, hash map, segmentation stream, simd utils), with the
same rows under the same names.

Host rows are timed with the host clock, as there. The device rows run on
the card and are timed between CUDA events after a warm-up: "device decode
4096 blocks" decodes 4,096 blocks packed at b = 8 through K3
(``ops/decode.py:decode_rows``, unpack and delta prefix sum: the work of
the JAX row's plain unpack), "device top_k 1M" is ``torch.topk`` (the JAX
row's ``lax.top_k``). The WAND ladder runs ``DeviceQuery(..., wand=True,
wand_mode=...)`` with ``exec/plan.py``'s ``JOIN_MAX_SPANS`` at 0, each
query fetched, on the host clock.

Run: ``python -m iresearch_tpu_torch.bench_micro``: a table to stdout
under a line naming the card and its power limit; no JSON line.
Without a card it fails at once.
"""

from __future__ import annotations

import sys
import time
from typing import List, Tuple

import numpy as np

WAND_MODES = ("exact", "strict", "approx")


def timeit(fn, n=20, warmup=2):
    """Host seconds per call of ``fn``."""
    for _ in range(warmup):
        fn()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return (time.perf_counter() - t0) / n


def device_time(fn, dev, n=20, warmup=2):
    """Seconds per call of ``fn`` on the device: between CUDA events
    around ``n`` calls after ``warmup`` calls; the host clock for a device
    that is not a card."""
    import torch

    if dev.type != "cuda":
        return timeit(fn, n, warmup)
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize(dev)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / 1e3 / n


def decode_args(words: np.ndarray, dev):
    """``decode_rows``' arguments for decoding every block of ``words``
    ([n, 32] u32, b = 8) as doc deltas and as freqs, block bases 0."""
    import torch

    w = torch.from_numpy(words.view(np.int32)).to(dev)
    n = w.shape[0]
    rows = torch.arange(n, dtype=torch.int32, device=dev)
    base = torch.zeros(n, dtype=torch.int32, device=dev)
    return (w, w, base, rows, rows), dict(bd=8, bf=8)


def run(*, device=None) -> List[Tuple[str, float]]:
    """The table's rows as (name, seconds) on ``device`` (the card when
    None; raises without one)."""
    import torch

    from iresearch_tpu_torch.exec.executor import entry_device

    dev = entry_device(device)
    rng = np.random.default_rng(0)
    rows = []

    # bitpack pack/unpack (simd_utils/bit_packing analog)
    from iresearch_tpu_torch.formats.bitpack import pack_blocks, unpack_blocks

    vals = rng.integers(0, 256, size=(4096, 128), dtype=np.uint64).astype(np.uint32)
    words = pack_blocks(vals, 8)
    rows.append(("pack_blocks b=8 (4096 blocks)", timeit(lambda: pack_blocks(vals, 8))))
    rows.append(("unpack_blocks b=8", timeit(lambda: unpack_blocks(words, 8))))

    # native tokenizer + termdict (segmentation stream + hash map analog)
    from iresearch_tpu_torch.native import TermDict, crc32c, load

    text = "the quick brown fox jumps over the lazy dog " * 40
    if load() is not None:
        def tok():
            d = TermDict()
            for _ in range(50):
                d.tokenize_to_tids(text, "lower", "alpha")
        rows.append(("native tokenize+tid 50x360tok", timeit(tok)))

    # crc (crc microbench analog)
    import zlib

    blob = rng.bytes(1 << 20)
    rows.append(("zlib.crc32 1MB", timeit(lambda: zlib.crc32(blob))))
    if crc32c(b"x") is not None:
        rows.append(("native crc32c 1MB", timeit(lambda: crc32c(blob))))

    # inversion (field_data::invert analog)
    from iresearch_tpu_torch.index.invert import invert_numpy

    N = 500_000
    tids = rng.integers(0, 30_000, N)
    doc = np.sort(rng.integers(0, 10_000, N))
    pos = np.arange(N) % 64
    rows.append(
        ("invert_numpy 500k tokens", timeit(lambda: invert_numpy(tids, doc, pos, 30_000, 10_000), n=5))
    )

    # device decode + topk (postings reader analog)
    from iresearch_tpu_torch.ops.decode import decode_rows

    args, kw = decode_args(words, dev)
    rows.append(("device decode 4096 blocks", device_time(lambda: decode_rows(*args, **kw), dev)))

    x = torch.from_numpy(rng.standard_normal(1 << 20).astype(np.float32)).to(dev)
    rows.append(("device top_k 1M", device_time(lambda: torch.topk(x, 10), dev)))

    # WAND mode ladder (exact vs strict vs approx) on a prepared OR query:
    # the WandContext speed/recall knob (tests/test_wand_modes.py pins the
    # semantics; this records the speed side)
    from iresearch_tpu_torch import bench_mix
    from iresearch_tpu_torch.exec.executor import DeviceQuery
    from iresearch_tpu_torch.index.reader import DirectoryReader
    from iresearch_tpu_torch.index.writer import Field, IndexWriter, IndexWriterOptions
    from iresearch_tpu_torch.search import filters as F
    from iresearch_tpu_torch.store.directory import MemoryDirectory

    words16 = [f"w{i:02d}" for i in range(40)]
    d = MemoryDirectory()
    with IndexWriter(d, IndexWriterOptions(invert_backend="numpy"), device=dev) as w:
        bulk = rng.integers(0, len(words16), size=(20_000, 24))
        for row in bulk:
            w.insert([Field("body", " ".join(words16[j] for j in row),
                            analyzer="segmentation")])
        w.commit()
    r = DirectoryReader.open(d, device=dev)
    flt = F.Or(*[F.ByTerm("body", f"w{i:02d}") for i in range(6)])
    with bench_mix.planner_knobs(JOIN_MAX_SPANS=0):  # the WAND body itself
        for mode in WAND_MODES:
            dq = DeviceQuery(flt, list(r.segments), wand=True, wand_sample=8,
                             wand_mode=mode, device=dev)
            dq.execute_segment(0, 10)  # capture + upload
            rows.append(
                (f"wand 6-term OR 20k docs [{mode}]",
                 timeit(lambda dq=dq: dq.execute_segment(0, 10))),
            )

    # columnstore build (column writer analog)
    from iresearch_tpu_torch.formats.columnstore import ColumnBuilder

    def col():
        cb = ColumnBuilder("c")
        for i in range(20_000):
            cb.add(i, b"value-%d" % i)
        cb.build(20_000)

    rows.append(("column build 20k docs", timeit(col, n=5)))
    return rows


def main() -> int:
    from iresearch_tpu_torch.bench import card_label
    from iresearch_tpu_torch.device import require_cuda

    try:
        dev = require_cuda()
    except RuntimeError as e:
        print(f"bench_micro: {e}", file=sys.stderr)
        return 1
    print(card_label(dev)[2], flush=True)
    rows = run(device=dev)
    w = max(len(n) for n, _ in rows)
    for name, t in rows:
        print(f"{name:<{w}}  {t * 1e3:10.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
