"""Index dumper (reference: utils/index-dump.cpp — print terms/postings/
columns per segment)."""

from __future__ import annotations

import argparse

from iresearch_tpu_torch.formats.postings import decode_positions, decode_term
from iresearch_tpu_torch.index.reader import DirectoryReader
from iresearch_tpu_torch.store.directory import FSDirectory


def parse_args(argv):
    p = argparse.ArgumentParser(prog="index_dump")
    p.add_argument("--index-dir", required=True)
    p.add_argument("--field", default=None, help="restrict to one field")
    p.add_argument("--max-terms", type=int, default=20)
    p.add_argument("--postings", action="store_true", help="dump doc lists")
    p.add_argument("--positions", action="store_true")
    p.add_argument("--columns", action="store_true")
    return p.parse_args(argv)


def main(argv) -> int:
    args = parse_args(argv)
    reader = DirectoryReader.open(FSDirectory(args.index_dir))
    print(f"generation {reader.meta.gen}; {len(reader.segments)} segments; "
          f"{reader.docs_count} docs ({reader.live_docs_count} live)")
    for si, sr in enumerate(reader.segments):
        print(f"segment {si} [{sr.name}]: {sr.num_docs} docs, "
              f"{sr.live_docs_count} live")
        for fname in sr.field_names():
            if args.field and fname != args.field:
                continue
            fp = sr.field(fname)
            print(f"  field {fname}: {fp.num_terms} terms, "
                  f"dwf={fp.docs_with_field} ttf={fp.total_term_freq} "
                  f"features={fp.features!r}")
            for tid in range(min(args.max_terms, fp.num_terms)):
                term = fp.term_bytes(tid)
                df = int(fp.entries[tid, 0])
                line = f"    {term!r} df={df}"
                if args.postings:
                    docs, freqs = decode_term(fp, tid)
                    line += f" docs={docs[:16].tolist()} freqs={freqs[:16].tolist()}"
                if args.positions and fp.has_positions:
                    pos = decode_positions(fp, tid)[:4]
                    line += f" pos={[p.tolist() for p in pos]}"
                print(line)
            if fp.num_terms > args.max_terms:
                print(f"    ... {fp.num_terms - args.max_terms} more")
        if args.columns:
            for cname in sr.column_names():
                col = sr.column(cname)
                print(f"  column {cname}: kind={col.kind}")
    return 0
