"""Checksummed multi-array container ("blobpack").

The reference serializes each index structure through byte streams with
vint coding and per-file CRC32 footers (core/store/data_output.hpp:38-123,
store_utils.hpp). The TPU engine instead wants each segment pool as one
contiguous, 64-byte-aligned buffer so it can be handed to
``jax.device_put`` / ``np.frombuffer`` without a decode pass — so a segment
file is a *pack of named numpy arrays* plus a JSON meta dict:

    [magic u32][header_len u32][header JSON][pad to 64]
    [blob 0][pad to 64][blob 1] ... [crc32 u32 of everything before]

The CRC plays the role of the reference's ``format_utils::check_footer``.
"""

from __future__ import annotations

import json
import zlib
from typing import Any, Dict, Mapping, Optional

import numpy as np

MAGIC = 0x54505549  # "IUPT"
_ALIGN = 64


class CorruptPackError(RuntimeError):
    pass


def _pad_to(n: int, align: int = _ALIGN) -> int:
    return (align - n % align) % align


class BlobPackWriter:
    """Builds a blobpack in memory; ``tobytes`` returns the file image."""

    def __init__(self, meta: Optional[Mapping[str, Any]] = None) -> None:
        self._meta: Dict[str, Any] = dict(meta or {})
        self._arrays: Dict[str, np.ndarray] = {}

    def set_meta(self, key: str, value: Any) -> None:
        self._meta[key] = value

    def add(self, name: str, array: np.ndarray) -> None:
        if name in self._arrays:
            raise ValueError(f"duplicate blob name: {name}")
        self._arrays[name] = np.ascontiguousarray(array)

    def tobytes(self) -> bytes:
        entries = []
        offset = 0
        blobs = []
        for name, arr in self._arrays.items():
            pad = _pad_to(offset)
            offset += pad
            blobs.append((pad, arr))
            entries.append(
                {
                    "name": name,
                    "dtype": arr.dtype.str,
                    "shape": list(arr.shape),
                    "offset": offset,
                    "nbytes": arr.nbytes,
                }
            )
            offset += arr.nbytes
        header = json.dumps({"meta": self._meta, "arrays": entries}).encode("utf-8")
        out = bytearray()
        out += np.array([MAGIC, len(header)], dtype="<u4").tobytes()
        out += header
        out += b"\x00" * _pad_to(len(out))
        data_start = len(out)
        for pad, arr in blobs:
            out += b"\x00" * pad
            out += arr.tobytes()
        # record where blob data starts so offsets resolve on read
        assert all(e["offset"] + data_start <= len(out) for e in entries)
        out[4:8] = np.array([len(header)], dtype="<u4").tobytes()
        crc = zlib.crc32(bytes(out))
        out += np.array([crc], dtype="<u4").tobytes()
        return bytes(out)


class BlobPackReader:
    """Zero-copy view over a blobpack byte buffer."""

    def __init__(self, data: bytes, verify: bool = True) -> None:
        if len(data) < 12:
            raise CorruptPackError("truncated blobpack")
        self._data = data
        magic, header_len = np.frombuffer(data[:8], dtype="<u4")
        if magic != MAGIC:
            raise CorruptPackError(f"bad magic: {magic:#x}")
        if verify:
            stored = np.frombuffer(data[-4:], dtype="<u4")[0]
            actual = zlib.crc32(data[:-4])
            if stored != actual:
                raise CorruptPackError(
                    f"checksum mismatch: stored={stored:#x} actual={actual:#x}"
                )
        header = json.loads(data[8 : 8 + int(header_len)].decode("utf-8"))
        self.meta: Dict[str, Any] = header["meta"]
        self._entries = {e["name"]: e for e in header["arrays"]}
        prefix = 8 + int(header_len)
        self._data_start = prefix + _pad_to(prefix)

    @property
    def lazy(self) -> bool:
        """True when the backing buffer decrypts/materializes per slice
        (store/codecs.py:LazyDecryptBuffer) — blobs should then be read
        on demand, not at open."""
        return bool(getattr(self._data, "lazy_decrypt", False))

    def names(self):
        return list(self._entries)

    def __contains__(self, name: str) -> bool:
        return name in self._entries

    def array(self, name: str) -> np.ndarray:
        """Return a read-only ndarray of blob ``name`` — a zero-copy view
        into the buffer (lazy OS pages under mmap), or a decrypted copy of
        just this blob's range for lazy-decrypt buffers."""
        e = self._entries[name]
        start = self._data_start + e["offset"]
        count = int(np.prod(e["shape"], dtype=np.int64))
        if self.lazy:
            buf = self._data[start : start + int(e["nbytes"])]
            arr = np.frombuffer(buf, dtype=np.dtype(e["dtype"]), count=count)
        else:
            arr = np.frombuffer(
                self._data, dtype=np.dtype(e["dtype"]), count=count, offset=start
            )
        return arr.reshape(e["shape"])

    def raw(self, name: str):
        """A sliceable view of blob ``name``'s bytes that defers any
        decrypt/page-in to each slice — for consumers that sub-slice
        (v6 column blocks) rather than touch the whole blob."""
        e = self._entries[name]
        start = self._data_start + e["offset"]
        if self.lazy:
            return _SubView(self._data, start, int(e["nbytes"]))
        return memoryview(self._data)[start : start + int(e["nbytes"])]


class _SubView:
    """Relative-sliceable window over a lazily-materializing buffer."""

    __slots__ = ("_buf", "_start", "_len")

    def __init__(self, buf, start: int, length: int) -> None:
        self._buf = buf
        self._start = start
        self._len = length

    def __len__(self) -> int:
        return self._len

    def __getitem__(self, key):
        if isinstance(key, slice):
            start, stop, step = key.indices(self._len)
            if step != 1:
                raise ValueError("sub-views are contiguous only")
            return self._buf[self._start + start : self._start + stop]
        i = key + self._len if key < 0 else key
        return self._buf[self._start + i]

    def tobytes(self) -> bytes:
        return bytes(self[0 : self._len])
