"""Column payload codecs (``iresearch_tpu/store/codecs.py``, compression half).

Segment files compress only the columnstore payloads, never the postings.
The port reads and writes the two codecs that need no system library,
``none`` and ``zlib``; a segment written with another codec (``lz4``,
``lz4dict``, ``delta``) raises ``KeyError`` on open. The JAX package's
ciphers and directory wrappers are not carried.
"""

from __future__ import annotations

import zlib
from typing import Callable, Dict, Optional


class Compressor:
    name = "none"

    def compress(self, data: bytes) -> bytes:
        return data

    def decompress(self, data: bytes) -> bytes:
        return data


class ZlibCompressor(Compressor):
    name = "zlib"

    def __init__(self, level: int = 6) -> None:
        self.level = level

    def compress(self, data: bytes) -> bytes:
        return zlib.compress(data, self.level)

    def decompress(self, data: bytes) -> bytes:
        return zlib.decompress(data)


_COMPRESSORS: Dict[str, Callable[[dict], Compressor]] = {
    "none": lambda a: Compressor(),
    "zlib": lambda a: ZlibCompressor(level=int(a.get("level", 6))),
}


def get_compressor(name: str, args: Optional[dict] = None) -> Compressor:
    """Named codec registry (reference: compression.cpp registry)."""
    if name not in _COMPRESSORS:
        raise KeyError(f"unknown compression: {name!r}")
    return _COMPRESSORS[name](args or {})
