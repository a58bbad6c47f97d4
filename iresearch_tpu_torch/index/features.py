"""Pluggable per-field feature columns (the FeatureWriter framework).

Reference: core/index/index_features.hpp:68-87 — ``FeatureWriterFactory``
instances are wired through ``IndexWriterOptions::features`` and, at
flush, each requested feature of each field emits its own column keyed by
the field; core/index/norm.hpp:46-198 ships the two built-ins: ``Norm``
(v1: float 1/sqrt(len)) and ``Norm2`` (int token count, tightest of
1/2/4-byte encodings). Usage in the reference CLI: index-put.cpp:439-452.

Here a FeatureWriter is a vectorized transform of per-doc field
statistics (currently the token-count vector — what segment_writer feeds
the reference feature writers) into per-doc encoded bytes; the writer
materializes one column per (feature, field) named ``@<feature>#<field>``
so features read back through the normal columnstore path.

A copy of ``iresearch_tpu/index/features.py``.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Callable, Dict, List, Tuple

import numpy as np


class FeatureWriter(ABC):
    """Encode per-doc field statistics into a feature column's values."""

    name: str = "abstract"

    @abstractmethod
    def encode(self, doc_lengths: np.ndarray) -> List[bytes]:
        """Per-doc encoded value for each doc WITH the field (len > 0)."""

    @abstractmethod
    def decode(self, value: bytes) -> float:
        """Read one encoded value back as a number."""


class Norm(FeatureWriter):
    """v1 norm: float32 1/sqrt(token_count) (reference: norm.hpp:46)."""

    name = "norm"

    def encode(self, doc_lengths: np.ndarray) -> List[bytes]:
        vals = (1.0 / np.sqrt(np.maximum(doc_lengths, 1))).astype(np.float32)
        return [v.tobytes() for v in vals]

    def decode(self, value: bytes) -> float:
        return float(np.frombuffer(value, np.float32)[0])


class Norm2(FeatureWriter):
    """v2 norm: integer token count in the tightest of 1/2/4 bytes
    (reference: norm.hpp:96-198 Norm2 encodings)."""

    name = "norm2"

    def encode(self, doc_lengths: np.ndarray) -> List[bytes]:
        mx = int(doc_lengths.max(initial=0))
        width = 1 if mx < (1 << 8) else (2 if mx < (1 << 16) else 4)
        return [int(v).to_bytes(width, "little") for v in doc_lengths]

    def decode(self, value: bytes) -> float:
        return float(int.from_bytes(value, "little"))


_FEATURES: Dict[str, Callable[[], FeatureWriter]] = {}


def register_feature(name: str, factory: Callable[[], FeatureWriter]) -> None:
    """Reference: IndexWriterOptions::features registration
    (index_features.hpp:68-87)."""
    _FEATURES[name] = factory


def get_feature(name: str) -> FeatureWriter:
    if name not in _FEATURES:
        raise KeyError(
            f"unknown feature {name!r} (have {sorted(_FEATURES)})"
        )
    return _FEATURES[name]()


register_feature("norm", Norm)
register_feature("norm2", Norm2)


def feature_column_name(feature: str, field: str) -> str:
    return f"@{feature}#{field}"


def build_feature_columns(
    field_name: str,
    feature_names,
    norms: np.ndarray,
    num_docs: int,
) -> Dict[str, "object"]:
    """Columns for every requested feature of one field (flush-time).

    ``norms`` is the per-doc token count (0 = doc lacks the field); only
    docs with the field get a value, like the reference's feature columns.
    """
    from iresearch_tpu_torch.formats.columnstore import column_from_parts

    out = {}
    docs = np.flatnonzero(norms > 0).astype(np.uint32)
    lens_tok = norms[docs]
    for feat in feature_names:
        fw = get_feature(feat)
        values = fw.encode(lens_tok)
        vlens = np.fromiter((len(v) for v in values), np.int64, count=len(values))
        out[feature_column_name(feat, field_name)] = column_from_parts(
            docs, vlens, b"".join(values), num_docs
        )
    return out


def read_feature(reader_or_segment, feature: str, field: str, doc: int):
    """Decode one doc's feature value from its column (None if absent)."""
    col_name = feature_column_name(feature, field)
    col = None
    if hasattr(reader_or_segment, "data"):  # SegmentReader
        col = reader_or_segment.data.columns.get(col_name)
    elif hasattr(reader_or_segment, "stored"):  # DirectoryReader
        raw = reader_or_segment.stored(doc, col_name)
        return None if raw is None else get_feature(feature).decode(raw)
    if col is None:
        return None
    raw = col.get(doc)
    return None if raw is None else get_feature(feature).decode(raw)
