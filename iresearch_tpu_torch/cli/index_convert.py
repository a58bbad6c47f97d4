"""Index transcoder (reference: utils/index-convert.cpp).

Reads any committed generation (any READABLE format version) and rewrites
it into a fresh directory in the requested target version (default: the
current format), optionally consolidating all segments into one — the same
re-encode path the reference's convert mode exercises across its 10
format versions. ``--device``: the device the writer is bound to (the
card unless named); converting inverts nothing.
"""

from __future__ import annotations

import argparse

from iresearch_tpu_torch.formats.segment_io import CURRENT_FORMAT, WRITABLE_FORMATS
from iresearch_tpu_torch.index.merge import merge_segments
from iresearch_tpu_torch.index.reader import DirectoryReader
from iresearch_tpu_torch.index.writer import IndexWriter, IndexWriterOptions
from iresearch_tpu_torch.store.directory import FSDirectory


def parse_args(argv):
    p = argparse.ArgumentParser(prog="index_convert")
    p.add_argument("--in", dest="input", required=True, help="source index dir")
    p.add_argument("--out", required=True, help="destination index dir")
    p.add_argument(
        "--consolidate", action="store_true", help="merge all segments into one"
    )
    p.add_argument(
        "--format",
        default=CURRENT_FORMAT,
        choices=sorted(WRITABLE_FORMATS),
        help="target on-disk segment format version",
    )
    p.add_argument("--device", default=None, help="torch device (default: the card)")
    return p.parse_args(argv)


def main(argv) -> int:
    args = parse_args(argv)
    reader = DirectoryReader.open(FSDirectory(args.input))
    out = FSDirectory(args.out)
    with IndexWriter(
        out, IndexWriterOptions(format_version=args.format), device=args.device
    ) as w:
        segs = list(reader.segments)
        if args.consolidate:
            datas = [merge_segments(segs)] if segs else []
        else:
            datas = [merge_segments([sr]) for sr in segs]
        w.import_segments(datas)
        w.commit()
    out_reader = DirectoryReader.open(out)
    print(
        f"converted {reader.live_docs_count} live docs -> "
        f"{len(out_reader.segments)} segments, {out_reader.docs_count} docs"
    )
    return 0
