"""pyresearch-compatible read-only API facade.

Reference: python/pyresearch.hpp:47-60 + python/swig/pyresearch.i — the
SWIG module exposing index_reader / segment_reader / field_reader /
term_iterator / doc_iterator / column readers. The engine is already
Python, so this module is a thin iterator-style facade over the native
readers, letting scripts written against pyresearch (e.g.
python/scripts/index-dump.py) port with only an import change.

A copy of ``iresearch_tpu/pyresearch.py`` over the port's
``DirectoryReader``, ``FSDirectory`` and ``formats.postings.decode_term``;
it reads on the host and touches no device.
"""

from __future__ import annotations

from typing import Iterator, List, Optional

import numpy as np

from iresearch_tpu_torch.formats.postings import decode_term
from iresearch_tpu_torch.index.reader import DirectoryReader
from iresearch_tpu_torch.store.directory import FSDirectory


class doc_iterator:
    """Pull iterator over one term's postings (pyresearch.hpp:47)."""

    def __init__(self, docs: np.ndarray, freqs: np.ndarray) -> None:
        self._docs = docs
        self._freqs = freqs
        self._i = -1

    def next(self) -> bool:
        self._i += 1
        return self._i < len(self._docs)

    def seek(self, target: int) -> int:
        self._i = int(np.searchsorted(self._docs, target))
        if self._i >= len(self._docs):
            return 0xFFFFFFFF  # eof doc id
        return int(self._docs[self._i])

    def value(self) -> int:
        return int(self._docs[self._i])

    def freq(self) -> int:
        return int(self._freqs[self._i])

    def __iter__(self):
        while self.next():
            yield self.value()


SEEK_NOT_FOUND, SEEK_FOUND, SEEK_END = 0, 1, 2


class term_iterator:
    """Seekable term iterator (pyresearch.hpp term_iterator)."""

    def __init__(self, sr, field_name: str) -> None:
        self._sr = sr
        self._field = field_name
        self._fp = sr.field(field_name)
        self._terms = sr.terms(field_name)
        self._i = -1

    def next(self) -> bool:
        self._i += 1
        return self._i < len(self._terms)

    def seek(self, term) -> bool:
        term = term.encode() if isinstance(term, str) else term
        tid = self._sr.lookup_term(self._field, term)
        if tid is None:
            return False
        self._i = tid
        return True

    def seek_ge(self, term) -> int:
        import bisect

        term = term.encode() if isinstance(term, str) else term
        i = bisect.bisect_left(self._terms, term)
        if i >= len(self._terms):
            return SEEK_END
        self._i = i
        return SEEK_FOUND if self._terms[i] == term else SEEK_NOT_FOUND

    def value(self) -> bytes:
        return self._terms[self._i]

    def postings(self, features: Optional[List[str]] = None) -> doc_iterator:
        docs, freqs = decode_term(self._fp, self._i)
        return doc_iterator(docs, freqs)


class field_reader:
    def __init__(self, sr, name: str) -> None:
        self._sr = sr
        self._name = name
        self._fp = sr.field(name)

    def name(self) -> str:
        return self._name

    def docs_count(self) -> int:
        return self._fp.docs_with_field

    def features(self) -> int:
        return int(self._fp.features)

    def norm(self) -> bool:
        return True  # norms always recorded

    def min(self) -> bytes:
        return self._fp.term_bytes(0) if self._fp.num_terms else b""

    def max(self) -> bytes:
        return (
            self._fp.term_bytes(self._fp.num_terms - 1)
            if self._fp.num_terms
            else b""
        )

    def terms_count(self) -> int:
        return self._fp.num_terms

    def iterator(self) -> term_iterator:
        return term_iterator(self._sr, self._name)


class column_meta:
    def __init__(self, name: str, cid: int) -> None:
        self._name = name
        self._id = cid

    def name(self) -> str:
        return self._name

    def id(self) -> int:
        return self._id


class column_values:
    """Iterable of doc ids carrying the column; [] returns the payload."""

    def __init__(self, col) -> None:
        self._col = col

    def __iter__(self) -> Iterator[int]:
        return iter(int(d) for d in self._col.doc_ids())

    def __getitem__(self, doc: int) -> Optional[bytes]:
        return self._col.get(doc)


class segment_reader:
    def __init__(self, sr) -> None:
        self._sr = sr

    def docs_count(self) -> int:
        return self._sr.num_docs

    def live_docs_count(self) -> int:
        return self._sr.live_docs_count

    def fields(self) -> List[field_reader]:
        return [field_reader(self._sr, n) for n in self._sr.field_names()]

    def field(self, name: str) -> Optional[field_reader]:
        return field_reader(self._sr, name) if self._sr.field(name) else None

    def columns(self) -> List[column_meta]:
        return [
            column_meta(n, i) for i, n in enumerate(self._sr.column_names())
        ]

    def column(self, ref) -> Optional[column_values]:
        if isinstance(ref, int):
            names = self._sr.column_names()
            if not 0 <= ref < len(names):
                return None
            ref = names[ref]
        col = self._sr.column(ref)
        return column_values(col) if col is not None else None


class index_reader:
    """Top-level reader (pyresearch index_reader)."""

    def __init__(self, reader: DirectoryReader) -> None:
        self._reader = reader

    @staticmethod
    def open(path: str) -> "index_reader":
        return index_reader(DirectoryReader.open(FSDirectory(path)))

    def docs_count(self) -> int:
        return self._reader.docs_count

    def live_docs_count(self) -> int:
        return self._reader.live_docs_count

    def __len__(self) -> int:
        return len(self._reader)

    def __iter__(self) -> Iterator[segment_reader]:
        return (segment_reader(sr) for sr in self._reader.segments)
