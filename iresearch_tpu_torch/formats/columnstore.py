"""Columnstore: per-document stored values.

Reference: core/formats/columnstore2.{hpp,cpp} — a column is up-to-64k-doc
blocks with dense/sparse/mask encodings and a sparse-bitmap doc index.
Here a column is one of three layouts chosen automatically at build time:

* ``dense``  — every doc in [0, num_docs) has a value: ``offsets[nd+1]`` + blob
* ``sparse`` — sorted ``docs[n]`` + ``offsets[n+1]`` + blob; lookup is
  ``searchsorted`` (the role of the reference's rank-enabled sparse bitmap)
* ``mask``   — sorted ``docs[n]`` only (presence, no payload;
  reference: ColumnType::kMask, columnstore2.hpp:208-219)

Values are raw bytes; typed helpers pack/unpack numerics. A copy of
``iresearch_tpu/formats/columnstore.py``.
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple

import numpy as np

# values per compression block (format v6+); reference:
# columnstore2.hpp:83 — columns are split into 65536-doc blocks with
# per-block compression so a point read decompresses one block, not the
# whole column
COLUMN_BLOCK = 65536
_BLOCK_SHIFT = 16
_BLOCK_CACHE = 8  # decompressed blocks kept per column


def _pack_bits(vals: np.ndarray, w: int) -> np.ndarray:
    """LSB-first bit-pack of non-negative ``vals`` at ``w`` bits each
    into a u8 stream (format v7 address tables)."""
    if w == 0 or len(vals) == 0:
        return np.zeros(0, np.uint8)
    v = vals.astype(np.uint64)
    n = len(v)
    nbytes = (n * w + 7) >> 3
    bits = ((v[:, None] >> np.arange(w, dtype=np.uint64)) & 1).astype(np.uint8)
    flat = np.zeros(nbytes * 8, np.uint8)
    flat[: n * w] = bits.ravel()
    return np.packbits(flat, bitorder="little")


def _unpack_bits(packed: np.ndarray, w: int, n: int) -> np.ndarray:
    """Inverse of :func:`_pack_bits` — ``n`` values of ``w`` bits → u64."""
    if w == 0 or n == 0:
        return np.zeros(n, np.uint64)
    flat = np.unpackbits(packed, bitorder="little", count=n * w)
    bits = flat.reshape(n, w).astype(np.uint64)
    return (bits << np.arange(w, dtype=np.uint64)).sum(axis=1)


class PackedOffsets:
    """Bit-packed column address table (format v7).

    The raw v6 table is u64 ``[n+1]`` — 8 B/value. Here value LENGTHS are
    bit-packed per 65536-value block at the block's minimal width, with
    u64 absolute bases only at block boundaries — typically ≤ 1 B/value
    (reference: columnstore2.hpp:83 avg-encoded address tables). Supports
    the narrow indexing surface the readers use (``x[i]``, ``len``) and
    decodes one block per touch with a small LRU, so lazy/mapped opens
    never materialize the full table."""

    def __init__(
        self,
        bases: np.ndarray,  # u64 [nb+1] absolute offsets at block bounds
        widths: np.ndarray,  # u8  [nb] bits per length in each block
        pack: np.ndarray,  # u8 concatenated per-block bit streams
        pack_offs: np.ndarray,  # u64 [nb+1] byte offsets into ``pack``
        nvals: int,  # number of VALUES (table length is nvals+1)
    ) -> None:
        self.bases = bases
        self.widths = widths
        self.pack_bytes = pack
        self.pack_offs = pack_offs
        self._n = nvals
        self._cache: "OrderedDict[int, np.ndarray]" = OrderedDict()

    @classmethod
    def pack(cls, offsets: np.ndarray) -> "PackedOffsets":
        n = len(offsets) - 1
        nb = max(1, -(-n // COLUMN_BLOCK))
        lens = np.diff(offsets.astype(np.int64))
        bases = np.zeros(nb + 1, np.uint64)
        widths = np.zeros(nb, np.uint8)
        poffs = np.zeros(nb + 1, np.uint64)
        parts = []
        for b in range(nb):
            lo, hi = b << _BLOCK_SHIFT, min((b + 1) << _BLOCK_SHIFT, n)
            bases[b] = offsets[lo]
            blk = lens[lo:hi]
            w = int(blk.max(initial=0)).bit_length()
            widths[b] = w
            part = _pack_bits(blk, w)
            parts.append(part)
            poffs[b + 1] = poffs[b] + len(part)
        bases[nb] = offsets[n]
        pack = (
            np.concatenate(parts) if parts else np.zeros(0, np.uint8)
        )
        return cls(bases, widths, pack, poffs, n)

    def __len__(self) -> int:
        return self._n + 1

    def _block(self, b: int) -> np.ndarray:
        """Absolute offsets [nv+1] of block ``b``."""
        blk = self._cache.get(b)
        if blk is None:
            lo, hi = int(self.pack_offs[b]), int(self.pack_offs[b + 1])
            nv = min(COLUMN_BLOCK, self._n - (b << _BLOCK_SHIFT))
            lens = _unpack_bits(
                np.asarray(self.pack_bytes[lo:hi]), int(self.widths[b]), nv
            )
            blk = np.zeros(nv + 1, np.uint64)
            np.cumsum(lens, out=blk[1:])
            blk += self.bases[b]
            self._cache[b] = blk
            while len(self._cache) > _BLOCK_CACHE:
                self._cache.popitem(last=False)
        else:
            self._cache.move_to_end(b)
        return blk

    def __getitem__(self, i: int) -> np.uint64:
        if i < 0:
            i += self._n + 1
        if not (0 <= i <= self._n):
            raise IndexError(i)
        if (i & (COLUMN_BLOCK - 1)) == 0:  # block bound: no decode
            return self.bases[i >> _BLOCK_SHIFT]
        if i == self._n:
            return self.bases[-1]
        b = i >> _BLOCK_SHIFT
        return self._block(b)[i & (COLUMN_BLOCK - 1)]

    def materialize(self) -> np.ndarray:
        """Full u64 [n+1] table (merge/convert/re-write paths)."""
        nb = len(self.widths)
        out = np.zeros(self._n + 1, np.uint64)
        for b in range(nb):
            lo, hi = b << _BLOCK_SHIFT, min((b + 1) << _BLOCK_SHIFT, self._n)
            out[lo : hi + 1] = self._block(b)
        out[self._n] = self.bases[-1]
        return out

    @property
    def nbytes(self) -> int:
        return (
            self.bases.nbytes
            + self.widths.nbytes
            + self.pack_bytes.nbytes
            + self.pack_offs.nbytes
        )


def offsets_array(offsets) -> Optional[np.ndarray]:
    """``offsets`` as a plain u64 ndarray (materializes PackedOffsets)."""
    if offsets is None:
        return None
    if isinstance(offsets, PackedOffsets):
        return offsets.materialize()
    return offsets


class ColumnBlocks:
    """Lazily-decompressed per-block column payloads (format v6).

    ``read(i, lo, hi)`` returns value ``i``'s bytes, where [lo, hi) are
    its absolute offsets in the UNCOMPRESSED blob; only the 65536-value
    block containing ``i`` is decompressed, with a small LRU of hot
    blocks (reference: columnstore2 block reads, columnstore2.hpp:208)."""

    def __init__(
        self,
        comp: bytes,  # concatenated compressed blocks
        block_offs: np.ndarray,  # u64 [nb+1] into ``comp``
        offsets: np.ndarray,  # u64 [n+1] absolute uncompressed offsets
        codec,
        nvals: int,
    ) -> None:
        self._comp = comp
        self._boffs = block_offs
        self._offsets = offsets
        self._codec = codec
        self._nvals = nvals
        self._cache: "OrderedDict[int, bytes]" = OrderedDict()

    def _block(self, b: int) -> bytes:
        blk = self._cache.get(b)
        if blk is None:
            lo, hi = int(self._boffs[b]), int(self._boffs[b + 1])
            raw = bytes(self._comp[lo:hi])
            if b > 0 and getattr(self._codec, "dict_blocks", False):
                # carried-dict codecs (lz4dict) compress blocks 1+ against
                # block 0 — a point read needs at most one extra block
                blk = self._codec.decompress_with_dict(raw, self._block(0))
            else:
                blk = self._codec.decompress(raw)
            self._cache[b] = blk
            while len(self._cache) > _BLOCK_CACHE:
                self._cache.popitem(last=False)
        else:
            self._cache.move_to_end(b)
        return blk

    def read(self, i: int, lo: int, hi: int) -> bytes:
        b = i >> _BLOCK_SHIFT
        base = int(self._offsets[b << _BLOCK_SHIFT])
        return self._block(b)[lo - base : hi - base]

    def tobytes(self) -> bytes:
        """The whole uncompressed blob (merge/convert path)."""
        return b"".join(
            self._block(b) for b in range(len(self._boffs) - 1)
        )


def split_column_blocks(offsets: np.ndarray, blob: bytes, codec):
    """(concatenated compressed blocks, block_offs u64 [nb+1]) for the
    v6 write path: one compressed chunk per 65536 values."""
    n = len(offsets) - 1
    nb = max(1, -(-n // COLUMN_BLOCK))
    parts = []
    boffs = np.zeros(nb + 1, np.uint64)
    with_dict = getattr(codec, "dict_blocks", False)
    dict0 = None
    for b in range(nb):
        lo = int(offsets[b << _BLOCK_SHIFT])
        hi = int(offsets[min((b + 1) << _BLOCK_SHIFT, n)])
        chunk = blob[lo:hi]
        if b == 0:
            part = codec.compress(chunk)
            if with_dict:
                dict0 = chunk
        elif with_dict:
            part = codec.compress_with_dict(chunk, dict0)
        else:
            part = codec.compress(chunk)
        parts.append(part)
        boffs[b + 1] = boffs[b] + len(part)
    return b"".join(parts), boffs


@dataclass
class Column:
    kind: str  # dense | sparse | mask
    docs: Optional[np.ndarray]  # u32 [n], None for dense
    offsets: Optional[np.ndarray]  # u64 [n+1], None for mask
    blob: bytes
    num_docs: int
    # format v6: per-block lazily-decompressed payloads (blob stays b"")
    blocks: Optional[ColumnBlocks] = None

    def _value(self, i: int) -> bytes:
        lo, hi = int(self.offsets[i]), int(self.offsets[i + 1])
        if self.blocks is not None:
            return self.blocks.read(i, lo, hi)
        return bytes(self.blob[lo:hi])

    def full_blob(self) -> bytes:
        """Whole uncompressed payload (merge/convert path)."""
        if self.blocks is not None:
            return self.blocks.tobytes()
        return bytes(self.blob)

    @property
    def size(self) -> int:
        """Number of documents that carry this column."""
        if self.kind == "dense":
            return self.num_docs
        return len(self.docs)

    def doc_ids(self) -> np.ndarray:
        if self.kind == "dense":
            return np.arange(self.num_docs, dtype=np.uint32)
        return self.docs

    def has(self, doc: int) -> bool:
        if self.kind == "dense":
            return 0 <= doc < self.num_docs
        i = np.searchsorted(self.docs, doc)
        return i < len(self.docs) and self.docs[i] == doc

    def get(self, doc: int) -> Optional[bytes]:
        """Value for ``doc`` or None; mask columns return b'' when present."""
        if self.kind == "dense":
            if not (0 <= doc < self.num_docs):
                return None
            return self._value(doc)
        i = int(np.searchsorted(self.docs, doc))
        if i >= len(self.docs) or self.docs[i] != doc:
            return None
        if self.kind == "mask":
            return b""
        return self._value(i)

    def items(self) -> Iterator[Tuple[int, bytes]]:
        if self.kind == "dense":
            for d in range(self.num_docs):
                yield d, self._value(d)
        elif self.kind == "mask":
            for d in self.docs:
                yield int(d), b""
        else:
            for i, d in enumerate(self.docs):
                yield int(d), self._value(i)


class ColumnBuilder:
    """Accumulates (doc, value) pairs in ascending doc order."""

    def __init__(self, name: str) -> None:
        self.name = name
        self._docs: List[int] = []
        self._chunks: List[bytes] = []
        self._all_empty = True

    def add(self, doc: int, value: bytes = b"") -> None:
        if self._docs and doc < self._docs[-1]:
            raise ValueError("column docs must be added in ascending order")
        if self._docs and doc == self._docs[-1]:
            # multi-valued: concatenate (reference columns store one payload
            # per doc; writers append)
            self._chunks[-1] += value
            return
        self._docs.append(doc)
        self._chunks.append(bytes(value))
        if value:
            self._all_empty = False

    def build(self, num_docs: int) -> Column:
        n = len(self._docs)
        docs = np.asarray(self._docs, dtype=np.uint32)
        if self._all_empty:
            return Column("mask", docs, None, b"", num_docs)
        if n == num_docs:
            lens = np.fromiter((len(c) for c in self._chunks), np.uint64, count=n)
            offsets = np.zeros(n + 1, np.uint64)
            np.cumsum(lens, out=offsets[1:])
            return Column("dense", None, offsets, b"".join(self._chunks), num_docs)
        lens = np.fromiter((len(c) for c in self._chunks), np.uint64, count=n)
        offsets = np.zeros(n + 1, np.uint64)
        if n:
            np.cumsum(lens, out=offsets[1:])
        return Column("sparse", docs, offsets, b"".join(self._chunks), num_docs)


def column_parts(
    col: Column, doc_map: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, bytes]:
    """Vectorized (new_docs, value_lens, values_blob) of the surviving,
    remapped docs of a column, ordered by new doc id — no per-doc Python.

    ``doc_map`` maps old->new doc ids (-1 = dropped). Building blocks for
    remap_column and the merge_writer column path (reference:
    merge_writer.cpp column merge; a 1M-doc column remaps in numpy time,
    not interpreter time)."""
    old_docs = col.doc_ids()
    nd = doc_map[old_docs.astype(np.int64)]
    keep = nd >= 0
    new_docs = nd[keep].astype(np.uint32)
    order = np.argsort(new_docs, kind="stable")
    new_docs = new_docs[order]
    if col.kind == "mask" or col.offsets is None:
        return new_docs, np.zeros(len(new_docs), np.int64), b""
    offs = offsets_array(col.offsets)
    lens_all = np.diff(offs.astype(np.int64))
    starts_all = offs[:-1].astype(np.int64)
    lens = lens_all[keep][order]
    starts = starts_all[keep][order]
    total = int(lens.sum())
    if total == 0:
        return new_docs, lens, b""
    blob_arr = np.frombuffer(col.full_blob(), np.uint8)
    within = np.arange(total, dtype=np.int64) - np.repeat(
        np.cumsum(lens) - lens, lens
    )
    blob = blob_arr[np.repeat(starts, lens) + within].tobytes()
    return new_docs, lens, blob


def column_from_parts(
    docs: np.ndarray, lens: np.ndarray, blob: bytes, num_docs: int
) -> Column:
    """Assemble a Column from vectorized parts (docs ascending unique)."""
    n = len(docs)
    if len(blob) == 0 and (n == 0 or int(lens.max(initial=0)) == 0):
        return Column("mask", docs.astype(np.uint32), None, b"", num_docs)
    offsets = np.zeros(n + 1, np.uint64)
    np.cumsum(lens.astype(np.uint64), out=offsets[1:])
    if n == num_docs:
        return Column("dense", None, offsets, blob, num_docs)
    return Column("sparse", docs.astype(np.uint32), offsets, blob, num_docs)


def remap_column(col: Column, doc_map: np.ndarray, new_num_docs: int) -> Column:
    """Rebuild a column under an old->new doc id mapping (-1 = dropped).

    Used by merge/consolidation (reference: merge_writer.cpp column merge).
    Fully vectorized — no per-doc Python loop.
    """
    docs, lens, blob = column_parts(col, doc_map)
    return column_from_parts(docs, lens, blob, new_num_docs)
