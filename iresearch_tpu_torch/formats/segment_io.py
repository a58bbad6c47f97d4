"""Segment serialization: SegmentData <-> one blobpack file.

Reference analog: the per-segment file family (.doc/.pos/.tm/.ti/.cs/.sm,
formats_10.cpp:325-333) collapses into a single checksummed pack whose
arrays are 64-byte aligned for direct device upload.

Format versions (reference analog: the format registry's named versions
1_0..1_5simd, formats.hpp:429-480, and index-convert.cpp transcoding):

* ``iresearch_tpu/3`` — planar pow2-bit-packed doc/freq split pools,
  positions stored as a raw flat u32 array, 10-column term entries.
* ``iresearch_tpu/4`` — positions bit-packed per term into classed
  128-lane block pools (PCLS/PSTART term columns); everything else as v3.
* ``iresearch_tpu/5`` — per-entry doc lengths (norms) bit-packed into
  classed pools parallel to the freq blocks (NCLS/NSTART columns), so
  scoring reads dl via the sequential row-gather path instead of a
  per-lane random gather from the [num_docs] norms array.

The writer emits v5 by default (or any version in WRITABLE_FORMATS); the
reader opens all and materializes the newest in-memory layout it can
(legacy segments get ``nrm_words=None`` and fall back to the gather path).
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from iresearch_tpu_torch.formats.columnstore import Column
from iresearch_tpu_torch.formats.postings import (
    FieldPostings,
    derive_norm_pools,
    pack_position_pools,
)
from iresearch_tpu_torch.formats.spec import (
    NUM_CLASSES,
    NUM_TERM_COLS,
    NUM_TERM_COLS_V3,
    NUM_TERM_COLS_V4,
    IndexFeatures,
    TermCols,
)
from iresearch_tpu_torch.store.blobpack import BlobPackReader, BlobPackWriter

FORMAT_V3 = "iresearch_tpu/3"
FORMAT_V4 = "iresearch_tpu/4"
FORMAT_V5 = "iresearch_tpu/5"
# v6: columns are compressed in 65536-value blocks (columnstore.py:
# ColumnBlocks) so stored-field point reads decompress one block, never
# the whole column (reference: columnstore2.hpp:83,208-219). Postings
# layout identical to v5.
FORMAT_V6 = "iresearch_tpu/6"
# v7: column address tables are bit-packed per 65536-value block
# (columnstore.py:PackedOffsets) — value lengths at the block's minimal
# width + u64 bases at block bounds, ~1 B/value vs v6's raw u64 8 B/value
# (reference: avg-encoded address tables, columnstore2.hpp:83). Payloads
# and postings identical to v6.
FORMAT_V7 = "iresearch_tpu/7"
CURRENT_FORMAT = FORMAT_V7
READABLE_FORMATS = {FORMAT_V3, FORMAT_V4, FORMAT_V5, FORMAT_V6, FORMAT_V7}
WRITABLE_FORMATS = {FORMAT_V3, FORMAT_V4, FORMAT_V5, FORMAT_V6, FORMAT_V7}
# versions whose fields carry inline norm pools (NCLS/NSTART + nrmw*)
_NORM_POOL_FORMATS = {FORMAT_V5, FORMAT_V6, FORMAT_V7}


def write_segment(
    seg: "SegmentData",
    column_compression: str = "none",
    version: str = CURRENT_FORMAT,
) -> bytes:  # noqa: F821
    from iresearch_tpu_torch.index.segment import SegmentData
    from iresearch_tpu_torch.store.codecs import get_compressor

    assert isinstance(seg, SegmentData)
    if version not in WRITABLE_FORMATS:
        raise ValueError(f"cannot write format {version!r}")
    codec = get_compressor(column_compression)
    meta = {
        "format": version,
        "num_docs": seg.num_docs,
        "fields": {},
        "columns": {},
    }
    w = BlobPackWriter()
    for fname, fp in seg.fields.items():
        key = f"f.{fname}"
        meta["fields"][fname] = {
            "docs_with_field": fp.docs_with_field,
            "total_term_freq": fp.total_term_freq,
            "features": int(fp.features),
            "has_positions": fp.has_positions,
        }
        w.add(f"{key}.term_blob", np.frombuffer(fp.term_blob, np.uint8))
        w.add(f"{key}.term_offsets", fp.term_offsets)
        if version == FORMAT_V3:
            w.add(f"{key}.entries", fp.entries[:, :NUM_TERM_COLS_V3])
            if fp.has_positions:
                w.add(f"{key}.pos", fp.positions_flat())
        elif version == FORMAT_V4:  # noqa: SIM114 — layout families
            w.add(f"{key}.entries", fp.entries[:, :NUM_TERM_COLS_V4])
            if fp.has_positions:
                for c in range(NUM_CLASSES):
                    w.add(f"{key}.posw{c}", fp.pos_words[c])
        else:
            w.add(f"{key}.entries", fp.entries)
            if fp.has_positions:
                for c in range(NUM_CLASSES):
                    w.add(f"{key}.posw{c}", fp.pos_words[c])
            if fp.nrm_words is None:  # legacy in-memory field (convert path)
                derive_norm_pools(fp)
            for c in range(NUM_CLASSES):
                w.add(f"{key}.nrmw{c}", fp.nrm_words[c])
        w.add(f"{key}.norms", fp.norms)
        if fp.offs_start is not None:
            w.add(f"{key}.ostart", fp.offs_start)
            w.add(f"{key}.oend", fp.offs_end)
        if fp.pay_len is not None:
            w.add(f"{key}.paylen", fp.pay_len)
            w.add(f"{key}.payblob", np.frombuffer(fp.pay_blob, np.uint8))
        for c in range(NUM_CLASSES):
            w.add(f"{key}.docw{c}", fp.doc_words[c])
            w.add(f"{key}.freqw{c}", fp.freq_words[c])
            w.add(f"{key}.base{c}", fp.base[c])
            w.add(f"{key}.bmax{c}", fp.bmax[c])
            w.add(f"{key}.bmaxf{c}", fp.bmaxf[c])
    for cname, col in seg.columns.items():
        key = f"c.{cname}"
        # stored-value payloads are compressed; postings pools are not
        # (reference: lz4 on the columnstore only, columnstore2.cpp)
        cmeta = {"kind": col.kind, "codec": codec.name}
        if col.docs is not None:
            w.add(f"{key}.docs", col.docs)
        if col.offsets is not None:
            if version == FORMAT_V7:
                # bit-packed address table (columnstore.py:PackedOffsets)
                from iresearch_tpu_torch.formats.columnstore import (
                    PackedOffsets,
                    offsets_array,
                )

                po = (
                    col.offsets
                    if isinstance(col.offsets, PackedOffsets)
                    else PackedOffsets.pack(offsets_array(col.offsets))
                )
                cmeta["packed_offsets"] = True
                cmeta["nvals"] = int(len(po) - 1)
                w.add(f"{key}.obase", po.bases)
                w.add(f"{key}.owidth", po.widths)
                w.add(f"{key}.opack", po.pack_bytes)
                w.add(f"{key}.opoffs", po.pack_offs)
            else:
                from iresearch_tpu_torch.formats.columnstore import offsets_array

                w.add(f"{key}.offsets", offsets_array(col.offsets))
        blob = col.full_blob()
        if (
            version in (FORMAT_V6, FORMAT_V7)
            and codec.name != "none"
            and col.offsets is not None
            and len(blob)
        ):
            # 65536-value compression blocks: point reads decompress one
            # block (columnstore.py:ColumnBlocks)
            from iresearch_tpu_torch.formats.columnstore import split_column_blocks

            comp, boffs = split_column_blocks(col.offsets, blob, codec)
            cmeta["blocked"] = True
            w.add(f"{key}.cblocks", np.frombuffer(comp, np.uint8))
            w.add(f"{key}.cboffs", boffs)
        else:
            w.add(
                f"{key}.blob",
                np.frombuffer(codec.compress(blob), np.uint8),
            )
        meta["columns"][cname] = cmeta
    w.set_meta("segment", meta)
    return w.tobytes()


def _read_field_positions(r, key: str, entries: np.ndarray, fmt: str):
    """(entries padded to the current column count, pos_words)."""
    if fmt == FORMAT_V3:
        # legacy 10-column entries; repack flat positions into the v4
        # classed block pools when present
        full = np.zeros((entries.shape[0], NUM_TERM_COLS), np.uint32)
        full[:, :NUM_TERM_COLS_V3] = entries
        if f"{key}.pos" not in r:
            return full, None
        pos_flat = r.array(f"{key}.pos")
        ttf = entries[:, TermCols.TTF].astype(np.int64)
        pcls, pstart, pools = pack_position_pools(pos_flat, ttf)
        full[:, TermCols.PCLS] = pcls
        full[:, TermCols.PSTART] = pstart
        return full, pools
    if fmt == FORMAT_V4:  # 12-column entries, no NCLS/NSTART
        full = np.zeros((entries.shape[0], NUM_TERM_COLS), np.uint32)
        full[:, :NUM_TERM_COLS_V4] = entries
        entries = full
    if f"{key}.posw0" not in r:
        return entries, None
    pools = tuple(r.array(f"{key}.posw{c}") for c in range(NUM_CLASSES))
    return entries, pools


def _read_field(r: BlobPackReader, fname: str, fm: dict, fmt: str) -> FieldPostings:
    key = f"f.{fname}"
    entries = r.array(f"{key}.entries")
    entries2, pos_words = _read_field_positions(r, key, entries, fmt)
    return FieldPostings(
        term_blob=r.array(f"{key}.term_blob").tobytes(),
        term_offsets=r.array(f"{key}.term_offsets"),
        entries=entries2,
        base=tuple(r.array(f"{key}.base{c}") for c in range(NUM_CLASSES)),
        bmax=tuple(r.array(f"{key}.bmax{c}") for c in range(NUM_CLASSES)),
        bmaxf=tuple(r.array(f"{key}.bmaxf{c}") for c in range(NUM_CLASSES)),
        doc_words=tuple(r.array(f"{key}.docw{c}") for c in range(NUM_CLASSES)),
        freq_words=tuple(r.array(f"{key}.freqw{c}") for c in range(NUM_CLASSES)),
        norms=r.array(f"{key}.norms"),
        nrm_words=(
            tuple(r.array(f"{key}.nrmw{c}") for c in range(NUM_CLASSES))
            if fmt in _NORM_POOL_FORMATS
            else None
        ),
        pos_words=pos_words,
        docs_with_field=fm["docs_with_field"],
        total_term_freq=fm["total_term_freq"],
        features=IndexFeatures(fm["features"]),
        offs_start=r.array(f"{key}.ostart") if f"{key}.ostart" in r else None,
        offs_end=r.array(f"{key}.oend") if f"{key}.oend" in r else None,
        pay_len=r.array(f"{key}.paylen") if f"{key}.paylen" in r else None,
        pay_blob=(
            r.array(f"{key}.payblob").tobytes()
            if f"{key}.payblob" in r
            else b""
        ),
    )


def _read_column(
    r: BlobPackReader, cname: str, cm: dict, num_docs: int, data_is_bytes: bool
) -> Column:
    from iresearch_tpu_torch.store.codecs import get_compressor

    key = f"c.{cname}"
    codec = get_compressor(cm.get("codec", "none"))
    docs = r.array(f"{key}.docs") if f"{key}.docs" in r else None
    if cm.get("packed_offsets"):
        from iresearch_tpu_torch.formats.columnstore import PackedOffsets

        # v7 bit-packed address table — decoded one block per touch, so
        # mapped/lazy opens never fault in the full table
        offsets = PackedOffsets(
            r.array(f"{key}.obase"),
            r.array(f"{key}.owidth"),
            r.array(f"{key}.opack"),
            r.array(f"{key}.opoffs"),
            cm["nvals"],
        )
    else:
        offsets = r.array(f"{key}.offsets") if f"{key}.offsets" in r else None
    if cm.get("blocked"):
        from iresearch_tpu_torch.formats.columnstore import ColumnBlocks

        return Column(
            kind=cm["kind"],
            docs=docs,
            offsets=offsets,
            blob=b"",
            num_docs=num_docs,
            blocks=ColumnBlocks(
                # raw(): a point read faults in + decrypts ONE compression
                # block, not the whole column payload
                r.raw(f"{key}.cblocks"),
                r.array(f"{key}.cboffs"),
                offsets,
                codec,
                len(offsets) - 1,
            ),
        )
    return Column(
        kind=cm["kind"],
        docs=docs,
        offsets=offsets,
        blob=(
            codec.decompress(r.array(f"{key}.blob").tobytes())
            if codec.name != "none"
            # uncompressed payloads stay zero-copy views (lazy pages)
            else r.array(f"{key}.blob").tobytes()
            if data_is_bytes
            else memoryview(r.array(f"{key}.blob"))
        ),
        num_docs=num_docs,
    )


class _LazyMap(dict):
    """Dict whose values materialize on first access (encrypted mapped
    opens: a segment open reads only the header; each field/column
    decrypts when first touched). Subclasses dict so dataclass consumers
    (iteration, ``in``, ``.get``, ``[]``, ``len``) work unchanged."""

    def __init__(self, keys, build) -> None:
        super().__init__({k: None for k in keys})
        self._build = build
        self._done: set = set()

    def __getitem__(self, k):
        if k not in self._done:
            if k not in self:
                raise KeyError(k)
            super().__setitem__(k, self._build(k))
            self._done.add(k)
        return super().__getitem__(k)

    def get(self, k, default=None):
        try:
            return self[k]
        except KeyError:
            return default

    def items(self):
        return [(k, self[k]) for k in self]

    def values(self):
        return [self[k] for k in self]


def read_segment(data, verify: bool = True) -> "SegmentData":  # noqa: F821
    """Open a segment over ``data`` (bytes or an mmap-backed buffer).

    Every pool is a zero-copy view into ``data``: with an mmap buffer
    (store/directory.py:MMapDirectory) the host pages fields in on first
    touch — the reference's mmap_directory + IOAdvice semantics
    (mmap_directory.hpp:33). ``verify=False`` skips the whole-file CRC
    (which would fault in every page, defeating lazy opens).

    Over a lazy-decrypt buffer (store/codecs.py:LazyDecryptBuffer) the
    open reads just the header, and each field/column decrypts on first
    access — the reference's stream-granular encryption semantics
    (encryption.hpp:56-116)."""
    from iresearch_tpu_torch.index.segment import SegmentData

    r = BlobPackReader(data, verify=verify)
    meta = r.meta["segment"]
    fmt = meta.get("format")
    if fmt not in READABLE_FORMATS:
        raise ValueError(
            f"unsupported segment format {fmt!r}; this build reads "
            f"{sorted(READABLE_FORMATS)} (reference analog: format "
            f"registry versions, formats.hpp:429-480)"
        )
    nd = meta["num_docs"]
    data_is_bytes = isinstance(data, bytes)
    fmeta, cmeta = meta["fields"], meta["columns"]
    if r.lazy:
        fields = _LazyMap(fmeta, lambda n: _read_field(r, n, fmeta[n], fmt))
        columns = _LazyMap(
            cmeta, lambda n: _read_column(r, n, cmeta[n], nd, data_is_bytes)
        )
    else:
        fields = {n: _read_field(r, n, fm, fmt) for n, fm in fmeta.items()}
        columns = {
            n: _read_column(r, n, cm, nd, data_is_bytes)
            for n, cm in cmeta.items()
        }
    return SegmentData(num_docs=nd, fields=fields, columns=columns)
