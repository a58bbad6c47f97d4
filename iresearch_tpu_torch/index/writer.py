"""IndexWriter: transactions, flush, two-phase commit, deletes.

Reference: core/index/index_writer.hpp:181-560 — single-writer /
multi-transaction API with two-phase commit (``pending_segments_<gen>`` ->
atomic rename to ``segments_<gen>``), Remove/Replace by filter with tick
ordering, and background consolidation.

A copy of ``iresearch_tpu/index/writer.py``. The orchestration stays on
the host; flush runs the inversion sort (index/invert.py) and the
block-pool encoder (formats/postings.py). Delete filters are evaluated
with the host query evaluator. The one change is where a flush inverts:
``invert_backend`` "auto" (the default) and "device" run ``invert_device``
on the writer's ``device``, which is the card unless the caller names
another, and "numpy" runs ``invert_numpy`` on the host. A writer that
would invert on the card raises at construction where there is none.
"""

from __future__ import annotations

import functools
import os
import threading
from dataclasses import dataclass, field as dc_field
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from iresearch_tpu_torch.analysis import Analyzer, get as get_analyzer
from iresearch_tpu_torch.formats.columnstore import ColumnBuilder
from iresearch_tpu_torch.formats.postings import encode_field_postings
from iresearch_tpu_torch.formats.spec import IndexFeatures
from iresearch_tpu_torch.formats.segment_io import write_segment
from iresearch_tpu_torch.index.invert import invert_device, invert_numpy
from iresearch_tpu_torch.index.reader import (
    DirectoryReader,
    IndexMeta,
    SegmentInfo,
    read_meta,
)
from iresearch_tpu_torch.index.segment import SegmentData, SegmentReader
from iresearch_tpu_torch.store.blobpack import BlobPackWriter
from iresearch_tpu_torch.store.directory import Directory, clean_directory
from iresearch_tpu_torch.utils import log
from iresearch_tpu_torch.utils.timer import scoped_timer


@dataclass
class Field:
    """One document field action (reference: Action::Index/Store,
    index_writer.hpp:74-101 + segment_writer.hpp:92)."""

    name: str
    value: Any
    analyzer: Union[str, Analyzer] = "identity"
    index: bool = True
    store: bool = False
    # which per-posting payloads to record (reference: IndexFeatures
    # FREQ/POS/OFFS/PAY, index_features.hpp:40); OFFS stores token source
    # offsets, PAY stores Token.payload bytes
    features: IndexFeatures = IndexFeatures.FREQ | IndexFeatures.POS
    # named FeatureWriters to emit as per-field columns at flush
    # (reference: FeatureWriterFactory via IndexWriterOptions::features,
    # index_features.hpp:68-87; built-ins "norm"/"norm2", norm.hpp:46-198)
    feature_columns: Sequence[str] = ()


def _stored_bytes(value: Any) -> bytes:
    if isinstance(value, bytes):
        return value
    if isinstance(value, str):
        return value.encode("utf-8")
    if isinstance(value, (int, np.integer)):
        return int(value).to_bytes(8, "little", signed=True)
    if isinstance(value, float):
        return np.float64(value).tobytes()
    raise TypeError(f"cannot store value of type {type(value)}")


@dataclass(frozen=True)
class SortSpec:
    """Primary sort: docs within each flushed segment are reordered by the
    stored value of ``field`` (reference: Comparer + DocMap applied at
    flush, core/index/comparer.hpp:30, segment_writer.hpp:237).

    ``key`` maps the stored bytes to a sortable python value (default:
    bytes-lexicographic); docs lacking the column sort last.
    """

    field: str
    key: Optional[Any] = None  # Callable[[bytes], Any]
    descending: bool = False


@dataclass
class IndexWriterOptions:
    """Reference: IndexWriterOptions (index_writer.hpp:114-170)."""

    segment_docs_max: int = 1 << 20  # flush threshold per segment
    segment_memory_max: int = 1 << 31  # soft cap on pending token memory
    invert_backend: str = "auto"  # 'device' | 'numpy' | 'auto' (= 'device')
    keep_positions: bool = True
    column_compression: str = "none"  # stored-values codec (none | zlib | lz4)
    format_version: str = "iresearch_tpu/7"  # on-disk segment format to write
    sort: Optional[SortSpec] = None  # primary sort (None = insertion order)


class _PendingField:
    __slots__ = (
        "terms", "tok_tid", "tok_doc", "tok_pos", "doc_pos", "chunks",
        "features", "tok_ostart", "tok_oend", "tok_pay", "feature_columns",
    )

    def __init__(self) -> None:
        from iresearch_tpu_torch.native import TermDict

        self.terms = TermDict()  # native C++ hash when available
        # scalar fallback stream (non-bulk analyzers)
        self.tok_tid: List[int] = []
        self.tok_doc: List[int] = []
        self.tok_pos: List[int] = []
        # bulk chunks: (tids i32 [n], doc, base_pos) from the native
        # tokenize+lookup fast path
        self.chunks: List = []
        self.doc_pos: Dict[int, int] = {}  # next position per doc
        self.features = IndexFeatures.FREQ | IndexFeatures.POS
        # position-parallel aux (arrival order, scalar path only)
        self.tok_ostart: List[int] = []
        self.tok_oend: List[int] = []
        self.tok_pay: List[bytes] = []
        # named FeatureWriters requested for this field (union over docs)
        self.feature_columns: set = set()

    def streams(self):
        """Concatenated (tid, doc, pos) arrays in (doc asc, pos asc) order.

        Chunks and scalar appends both arrive in doc order, but one
        document may mix the two paths (e.g. a non-ASCII value tokenized
        scalar before an ASCII value handled by the bulk path), in which
        case concatenation alone would leave positions non-ascending
        within the doc; a final stable (doc, pos) sort restores the
        contract the inverter and delta codecs rely on."""
        parts_t = []
        parts_d = []
        parts_p = []
        si = 0
        scal_t = np.asarray(self.tok_tid, np.int64)
        scal_d = np.asarray(self.tok_doc, np.int64)
        scal_p = np.asarray(self.tok_pos, np.uint32)
        for tids, doc, base_pos in self.chunks:
            # emit any scalar tokens belonging to earlier docs first
            cut = np.searchsorted(scal_d, doc, side="left")
            if cut > si:
                parts_t.append(scal_t[si:cut])
                parts_d.append(scal_d[si:cut])
                parts_p.append(scal_p[si:cut])
                si = cut
            parts_t.append(tids.astype(np.int64))
            parts_d.append(np.full(len(tids), doc, np.int64))
            parts_p.append(
                (base_pos + np.arange(len(tids), dtype=np.uint32))
            )
        if si < len(scal_t):
            parts_t.append(scal_t[si:])
            parts_d.append(scal_d[si:])
            parts_p.append(scal_p[si:])
        if not parts_t:
            z = np.zeros(0, np.int64)
            return z, z, np.zeros(0, np.uint32)
        out_t = np.concatenate(parts_t)
        out_d = np.concatenate(parts_d)
        out_p = np.concatenate(parts_p)
        if self.chunks and len(scal_t):
            # mixed scalar/bulk within a doc can interleave positions
            order = np.lexsort((out_p, out_d))
            out_t, out_d, out_p = out_t[order], out_d[order], out_p[order]
        return out_t, out_d, out_p


class _PendingSegment:
    """In-RAM accumulation before flush (reference: segment_writer +
    field_data; core/index/segment_writer.cpp:76, field_data.cpp:985)."""

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        """Clear for reuse from the context pool (reference: pooled
        SegmentContexts, index_writer.hpp:183 + object_pool.hpp)."""
        self.num_docs = 0
        self.fields: Dict[str, _PendingField] = {}
        self.columns: Dict[str, ColumnBuilder] = {}
        self.ticks: List[int] = []  # per-doc insertion tick
        self.approx_tokens = 0

    def add_doc(self, fields: Sequence[Field], tick: int, analyzers) -> int:
        doc = self.num_docs
        self.num_docs += 1
        self.ticks.append(tick)
        for f in fields:
            if f.index:
                pf = self.fields.get(f.name)
                if pf is None:
                    pf = self.fields[f.name] = _PendingField()
                analyzer = analyzers(f.analyzer)
                pf.features |= f.features
                pf.feature_columns.update(f.feature_columns)
                pos = pf.doc_pos.get(doc, 0)
                base_pos = pos
                text = f.value if isinstance(f.value, str) else str(f.value)
                tids = None
                # once OFFS/PAY is requested for a field it stays on so
                # aux stays aligned with the token stream
                needs_aux = bool(
                    pf.features & (IndexFeatures.OFFS | IndexFeatures.PAY)
                )
                bulk = getattr(analyzer, "bulk_tids", None)
                if bulk is not None and not needs_aux:
                    # the C++ bulk path carries no offsets/payloads
                    tids = bulk(text, pf.terms)
                if tids is not None:
                    # native tokenize+termdict fast path (C++ inner loop)
                    pf.chunks.append((tids, doc, base_pos))
                    pos = base_pos + len(tids)
                    self.approx_tokens += len(tids)
                else:
                    for tok in analyzer.tokenize(text):
                        tid = pf.terms.add(tok.term)
                        pf.tok_tid.append(tid)
                        pf.tok_doc.append(doc)
                        pf.tok_pos.append(base_pos + tok.position)
                        if needs_aux:
                            pf.tok_ostart.append(tok.start)
                            pf.tok_oend.append(tok.end)
                            pf.tok_pay.append(tok.payload)
                        pos = base_pos + tok.position + 1
                        self.approx_tokens += 1
                pf.doc_pos[doc] = pos
            if f.store:
                cb = self.columns.get(f.name)
                if cb is None:
                    cb = self.columns[f.name] = ColumnBuilder(f.name)
                cb.add(doc, _stored_bytes(f.value))
        return doc

    def absorb(self, other: "_PendingSegment", ticks: List[int]) -> None:
        """Merge another pending segment (a transaction context) into this
        one: shift doc ids, remap term ids through this segment's term
        dictionaries (vectorized per field), append token streams. Both
        sides arrive doc-ordered, and every absorbed doc id exceeds every
        existing one, so stream order invariants hold by construction."""
        base = self.num_docs
        self.num_docs += other.num_docs
        self.ticks.extend(ticks)
        self.approx_tokens += other.approx_tokens
        for name, opf in other.fields.items():
            pf = self.fields.get(name)
            if pf is None:
                pf = self.fields[name] = _PendingField()
            pf.features |= opf.features
            pf.feature_columns |= opf.feature_columns
            tid_map = pf.terms.merge_from(opf.terms)
            for tids, doc, base_pos in opf.chunks:
                pf.chunks.append(
                    (tid_map[tids].astype(np.int32), doc + base, base_pos)
                )
            if opf.tok_tid:
                pf.tok_tid.extend(
                    tid_map[np.asarray(opf.tok_tid, np.int64)].tolist()
                )
                pf.tok_doc.extend(
                    (np.asarray(opf.tok_doc, np.int64) + base).tolist()
                )
                pf.tok_pos.extend(opf.tok_pos)
                pf.tok_ostart.extend(opf.tok_ostart)
                pf.tok_oend.extend(opf.tok_oend)
                pf.tok_pay.extend(opf.tok_pay)
            for d, p in opf.doc_pos.items():
                pf.doc_pos[d + base] = p
        for name, ocb in other.columns.items():
            cb = self.columns.get(name)
            if cb is None:
                cb = self.columns[name] = ColumnBuilder(name)
            for doc, chunk in zip(ocb._docs, ocb._chunks):
                cb.add(doc + base, chunk)

    def _sort_doc_map(self, spec: "SortSpec") -> Optional[np.ndarray]:
        """old->new doc id map for the primary sort, or None (no-op)."""
        if self.num_docs <= 1:
            return None
        from iresearch_tpu_torch.formats.columnstore import Column

        cb = self.columns.get(spec.field)
        values: Dict[int, bytes] = {}
        if cb is not None:
            for doc, chunk in zip(cb._docs, cb._chunks):
                values[doc] = chunk
        keyfn = spec.key or (lambda b: b)

        def key(doc: int):
            v = values.get(doc)
            # docs without the column sort last regardless of direction
            # (reference: Comparer receives an empty value)
            return (v is None, keyfn(v) if v is not None else None)

        order = sorted(range(self.num_docs), key=key, reverse=spec.descending)
        if spec.descending:
            # keep missing-value docs last under reverse too
            order = [d for d in order if values.get(d) is not None] + [
                d for d in order if values.get(d) is None
            ]
        doc_map = np.empty(self.num_docs, np.int64)
        doc_map[np.asarray(order)] = np.arange(self.num_docs)
        if (doc_map == np.arange(self.num_docs)).all():
            return None
        return doc_map

    def flush(self, opts: IndexWriterOptions, device=None) -> SegmentData:
        """Invert + encode all fields into an immutable SegmentData.

        'auto' and 'device' invert on ``device`` (the card when None),
        'numpy' on the host. The JAX package's 'auto' stays on numpy
        because its device sits behind a relay; on a locally attached card
        the device sort is ~10x the host's with the transfers counted, and
        the outputs are identical (tested)."""
        if opts.invert_backend == "numpy":
            invert = invert_numpy
        else:
            invert = functools.partial(invert_device, device=device)

        doc_map = self._sort_doc_map(opts.sort) if opts.sort else None
        if doc_map is not None:
            # primary sort: remap doc ids everywhere and reorder ticks
            # (reference: DocMap applied at flush, segment_writer.cpp:230)
            self.ticks = list(np.asarray(self.ticks)[np.argsort(doc_map)])

        def encode_one(name: str, pf: "_PendingField"):
            # sorted term dictionary + tid remap (reference sorts terms at
            # flush: fields_data::flush, field_data.cpp:1124)
            terms_raw = pf.terms.terms()
            order = sorted(range(len(terms_raw)), key=lambda i: terms_raw[i])
            terms_sorted = [terms_raw[i] for i in order]
            remap = np.zeros(len(terms_raw), np.int64)
            remap[np.asarray(order, np.int64)] = np.arange(len(order))
            raw_tid, tok_doc, tok_pos = pf.streams()
            tok_tid = remap[raw_tid]
            has_aux = bool(
                pf.features & (IndexFeatures.OFFS | IndexFeatures.PAY)
            )
            if has_aux and (pf.chunks or len(pf.tok_ostart) != len(raw_tid)):
                # covers both bulk chunks (which carry no offsets) and the
                # scalar path when earlier docs were indexed before
                # OFFS/PAY was first requested on this field
                raise ValueError(
                    "OFFS/PAY must be requested from the field's first "
                    "document (earlier tokens carry no offsets/payloads)"
                )
            ostart = np.asarray(pf.tok_ostart, np.uint32) if has_aux else None
            oend = np.asarray(pf.tok_oend, np.uint32) if has_aux else None
            pay = list(pf.tok_pay) if has_aux else None
            if doc_map is not None:
                tok_doc = doc_map[tok_doc]
                # restore (doc asc, pos asc) arrival order for the inverter
                order2 = np.argsort(tok_doc, kind="stable")
                tok_tid = tok_tid[order2]
                tok_doc = tok_doc[order2]
                tok_pos = tok_pos[order2]
                if has_aux:
                    ostart = ostart[order2]
                    oend = oend[order2]
                    pay = [pay[i] for i in order2]
            with scoped_timer("writer.invert"):
                inv = invert(
                    tok_tid,
                    tok_doc,
                    tok_pos,
                    len(terms_sorted),
                    self.num_docs,
                )
            blob = b"".join(terms_sorted)
            offsets = np.zeros(len(terms_sorted) + 1, np.uint64)
            np.cumsum([len(t) for t in terms_sorted], out=offsets[1:])
            offs = pays = None
            if has_aux and inv.order is not None and len(inv.order):
                if pf.features & IndexFeatures.OFFS:
                    offs = (ostart[inv.order], oend[inv.order])
                if pf.features & IndexFeatures.PAY:
                    pay_sorted = [pay[i] for i in inv.order]
                    pays = (
                        np.fromiter(
                            (len(b) for b in pay_sorted),
                            np.uint32,
                            count=len(pay_sorted),
                        ),
                        b"".join(pay_sorted),
                    )
            return encode_field_postings(
                inv.e_doc,
                inv.e_freq,
                inv.term_ptr,
                blob,
                offsets,
                inv.norms,
                pos_flat=inv.pos_flat if opts.keep_positions else None,
                features=pf.features,
                offs=offs,
                pays=pays,
            )

        # per-field encode is numpy-dominated (GIL-released), so fields
        # encode in parallel on multicore hosts (reference: one thread
        # per field family inside the consolidating flush,
        # utils/index-put.cpp:456-560); results are order-independent
        out_fields = {}
        items = list(self.fields.items())
        nthreads = min(
            len(items),
            int(os.environ.get("IRS_FLUSH_THREADS", os.cpu_count() or 1)),
        )
        if nthreads > 1:
            from iresearch_tpu_torch.utils.pools import ThreadPool, WaitGroup

            results: Dict[str, object] = {}
            errors: List[BaseException] = []
            pool = ThreadPool(nthreads, name="irs-flush")
            wg = WaitGroup()

            def run(nm, pfd):
                def task():
                    try:
                        results[nm] = encode_one(nm, pfd)
                    except BaseException as e:  # noqa: BLE001 — re-raised
                        errors.append(e)

                return task

            for name, pf in items:
                pool.submit(run(name, pf), wg)
            wg.wait()
            pool.stop()
            if errors:
                raise errors[0]
            out_fields = {name: results[name] for name, _ in items}
        else:
            for name, pf in items:
                out_fields[name] = encode_one(name, pf)
        columns = {
            name: cb.build(self.num_docs) for name, cb in self.columns.items()
        }
        if doc_map is not None:
            from iresearch_tpu_torch.formats.columnstore import remap_column

            columns = {
                name: remap_column(col, doc_map, self.num_docs)
                for name, col in columns.items()
            }
        # FeatureWriter columns (reference: FeatureWriterFactory per field,
        # index_features.hpp:68-87): built from post-sort doc lengths, so
        # no remap needed
        for name, pf in self.fields.items():
            if pf.feature_columns:
                from iresearch_tpu_torch.index.features import build_feature_columns

                columns.update(
                    build_feature_columns(
                        name,
                        sorted(pf.feature_columns),
                        out_fields[name].norms,
                        self.num_docs,
                    )
                )
        return SegmentData(self.num_docs, out_fields, columns)


class Transaction:
    """A batch of Insert/Remove/Replace operations
    (reference: IndexWriter::Transaction, index_writer.hpp:346-430).

    Each transaction owns a private _PendingSegment — the SegmentContext
    pool analog (index_writer.hpp:183,232): ``insert`` tokenizes and
    builds the term dictionary HERE, outside any writer lock, so N
    concurrent transactions analyze in parallel; ``register`` merges the
    pre-tokenized streams under the ingest mutex with a vectorized tid
    remap (reference: concurrent SegmentContexts flushed by tick,
    utils/index-put.cpp:456-560)."""

    def __init__(self, writer: "IndexWriter") -> None:
        self._writer = writer
        self._seg = writer._ctx_pool.acquire()
        self._ops: List = []  # ("insert", local_doc) | ("remove", filter)
        self._open = True

    def insert(self, fields: Sequence[Field]) -> None:
        assert self._open
        doc = self._seg.add_doc(list(fields), 0, self._writer._analyzer)
        self._ops.append(("insert", doc))

    def remove(self, filter_) -> None:
        assert self._open
        self._ops.append(("remove", filter_))

    def replace(self, filter_, fields: Sequence[Field]) -> None:
        """Atomic remove+insert (the insert is not visible to the remove)."""
        assert self._open
        self.remove(filter_)
        self.insert(fields)

    def register(self) -> None:
        """Publish this batch into the writer's pending state."""
        if not self._open:
            return
        self._open = False
        self._writer._register_batch(self._seg, self._ops)
        self._seg = None

    def rollback(self) -> None:
        self._open = False
        self._ops = []
        if self._seg is not None:
            self._seg.reset()
            self._writer._ctx_pool.release(self._seg)
        self._seg = None

    def __enter__(self) -> "Transaction":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is None:
            self.register()
        else:
            self.rollback()


class IndexWriter:
    """Single-writer index mutation API with snapshot-isolated commits."""

    def __init__(
        self,
        directory: Directory,
        options: Optional[IndexWriterOptions] = None,
        *,
        device=None,
    ) -> None:
        self._dir = directory
        self._opts = options or IndexWriterOptions()
        if self._opts.invert_backend not in ("auto", "device", "numpy"):
            raise ValueError(
                f"invert_backend {self._opts.invert_backend!r}: expected "
                "'auto', 'device' or 'numpy'"
            )
        # the device every flush inverts on, resolved before any insert so
        # that a host without a card fails here, not at the first commit
        self._device = None
        if self._opts.invert_backend != "numpy":
            from iresearch_tpu_torch.device import require_cuda

            self._device = (
                require_cuda() if device is None else torch.device(device)
            )
        self._lock = directory.lock()
        # two-lock double-buffering (reference: FlushContext switch,
        # index_writer.cpp:1712-1763): _mutex guards only the in-RAM ingest
        # buffers and is held for pointer swaps, never for encode or I/O;
        # _commit_lock serializes commit/consolidate publication so flush,
        # encode, and file writes run with inserts still flowing.
        self._mutex = threading.Lock()
        self._commit_lock = threading.Lock()
        # transaction-context pool (reference: pooled SegmentContexts,
        # index_writer.hpp:183,232 + unbounded_object_pool)
        from iresearch_tpu_torch.utils.pools import UnboundedObjectPool

        self._ctx_pool = UnboundedObjectPool(_PendingSegment, max_cached=8)
        self._meta = read_meta(directory)
        self._pending = _PendingSegment()
        # mixed list of SegmentData (imports) and sealed _PendingSegment
        # (rolled but not yet encoded); encode happens at commit, outside
        # the ingest mutex
        self._flushed: List = []
        self._flushed_ticks: List[List[int]] = []
        self._removes: List = []  # (tick, filter)
        self._tick = 0
        self._analyzer_cache: Dict[str, Analyzer] = {}
        # observability: mutex-held ingest time (see _register_batch)
        self.stats: Dict[str, float] = {"register_held_s": 0.0}

    # --- helpers -------------------------------------------------------

    def _analyzer(self, spec: Union[str, Analyzer]) -> Analyzer:
        if isinstance(spec, Analyzer):
            return spec
        a = self._analyzer_cache.get(spec)
        if a is None:
            a = get_analyzer(spec)
            self._analyzer_cache[spec] = a
        return a

    def _register_batch(self, tx_seg: "_PendingSegment", ops: List) -> None:
        """Merge a transaction's pre-tokenized segment under the ingest
        mutex. The mutex covers only tick assignment and the vectorized
        tid remap/append — tokenization already happened in the
        transaction (reference: SegmentContext pool, index_writer.hpp:183).

        ``stats['register_held_s']`` accumulates the mutex-HELD time (not
        acquisition wait) — the serial term in the thread-scaling Amdahl
        bound that bench_build.py and test_build_scaling.py report."""
        import time as _time

        with self._mutex:
            _t0 = _time.perf_counter()
            doc_ticks: List[int] = []
            for kind, payload in ops:
                self._tick += 1
                if kind == "insert":
                    doc_ticks.append(self._tick)
                else:
                    self._removes.append((self._tick, payload))
            if tx_seg.num_docs:
                if self._pending.num_docs == 0:
                    # common bulk-load shape: adopt the whole context
                    # (adopted contexts never return to the pool — they
                    # become the pending segment)
                    tx_seg.ticks = doc_ticks
                    self._pending = tx_seg
                else:
                    self._pending.absorb(tx_seg, doc_ticks)
                    tx_seg.reset()
                    self._ctx_pool.release(tx_seg)
                if self._pending.num_docs >= self._opts.segment_docs_max:
                    self._roll_segment_locked()
            else:
                tx_seg.reset()
                self._ctx_pool.release(tx_seg)
            self.stats["register_held_s"] += _time.perf_counter() - _t0

    def _roll_segment_locked(self) -> None:
        """Seal the in-progress segment — a pointer swap only. The
        expensive encode (_PendingSegment.flush) is deferred to commit()
        and runs OUTSIDE the ingest mutex, so _register_batch never waits
        for flush/encode/write (reference: double-buffered FlushContexts,
        index_writer.cpp:1712-1763)."""
        if self._pending.num_docs == 0:
            return
        self._flushed.append(self._pending)
        self._flushed_ticks.append(list(self._pending.ticks))
        self._pending = _PendingSegment()

    # --- public API ----------------------------------------------------

    def batch(self) -> Transaction:
        return Transaction(self)

    def insert(self, fields: Sequence[Field]) -> None:
        with self.batch() as tx:
            tx.insert(fields)

    def remove(self, filter_) -> None:
        with self.batch() as tx:
            tx.remove(filter_)

    @property
    def committed_meta(self) -> IndexMeta:
        return self._meta

    def import_segments(self, datas: Sequence[SegmentData]) -> None:
        """Add already-built segments (reference: IndexWriter::Import,
        index_writer.cpp:1653). They are published at the next commit;
        removes registered after this call apply to them."""
        with self._mutex:
            for seg in datas:
                self._tick += 1
                self._flushed.append(seg)
                self._flushed_ticks.append([self._tick] * seg.num_docs)

    def import_reader(self, reader) -> None:
        """Import every live doc of another index (cross-index segment copy)."""
        from iresearch_tpu_torch.index.merge import merge_segments

        self.import_segments([merge_segments([sr]) for sr in reader.segments])

    def begin(self) -> bool:
        """Prepare-commit (reference: IndexWriter::Begin). Combined into
        commit() here; provided for API parity."""
        return True

    def commit(self) -> bool:
        """Flush pending docs, apply removes, atomically publish a new
        generation. Returns False if there was nothing to commit.

        Holds _commit_lock for the duration (one committer at a time) but
        takes the ingest _mutex only for the buffer swap: transactions
        keep inserting into the fresh pending segment while this commit
        encodes and writes (reference: PrepareFlush/ApplyFlush split,
        index_writer.cpp:1814,2309)."""
        from iresearch_tpu_torch.search.host_eval import match_docs

        with self._commit_lock:
            with self._mutex:
                self._roll_segment_locked()
                staged = self._flushed
                flushed_ticks = self._flushed_ticks
                removes = self._removes
                self._flushed = []
                self._flushed_ticks = []
                self._removes = []

            if not staged and not removes:
                return False

            # encode sealed segments outside the ingest mutex
            flushed: List[SegmentData] = []
            for item in staged:
                if isinstance(item, _PendingSegment):
                    with scoped_timer("writer.flush"):
                        item = item.flush(self._opts, self._device)
                flushed.append(item)

            meta = self._meta
            new_gen = meta.gen + 1
            counter = meta.seg_counter
            new_infos: List[SegmentInfo] = []
            new_files: List[str] = []

            # apply removes to committed segments -> updated doc masks
            committed: List[SegmentInfo] = []
            for info in meta.segments:
                committed.append(
                    SegmentInfo(
                        info.name, info.file, info.num_docs, info.del_file, info.del_gen
                    )
                )
            if removes:
                reader = DirectoryReader.open(self._dir)
                for seg_idx, sr in enumerate(reader.segments):
                    masked = ~sr.alive
                    changed = False
                    for _, flt in removes:
                        docs = match_docs(flt, sr)
                        if len(docs):
                            newly = ~masked[docs]
                            if newly.any():
                                masked[docs] = True
                                changed = True
                    if changed:
                        info = committed[seg_idx]
                        info.del_gen += 1
                        info.del_file = f"{info.name}_{info.del_gen}.del"
                        w = BlobPackWriter()
                        w.add("docs", np.flatnonzero(masked).astype(np.uint32))
                        self._dir.write(info.del_file, w.tobytes())
                        new_files.append(info.del_file)

            # new segments from this commit (removes apply by tick order)
            for seg_data, ticks in zip(flushed, flushed_ticks):
                counter += 1
                name = f"_{counter}"
                masked = np.zeros(seg_data.num_docs, np.bool_)
                if removes:
                    sr = SegmentReader(name, seg_data)
                    tick_arr = np.asarray(ticks)
                    for rtick, flt in removes:
                        docs = match_docs(flt, sr)
                        if len(docs):
                            sel = docs[tick_arr[docs] < rtick]
                            masked[sel] = True
                info = SegmentInfo(name, f"{name}.seg", seg_data.num_docs)
                if masked.any():
                    info.del_gen = 1
                    info.del_file = f"{name}_1.del"
                    w = BlobPackWriter()
                    w.add("docs", np.flatnonzero(masked).astype(np.uint32))
                    self._dir.write(info.del_file, w.tobytes())
                    new_files.append(info.del_file)
                with scoped_timer("writer.write_segment"):
                    self._dir.write(
                        info.file,
                        write_segment(
                            seg_data,
                            self._opts.column_compression,
                            version=self._opts.format_version,
                        ),
                    )
                new_files.append(info.file)
                new_infos.append(info)

            new_meta = IndexMeta(
                gen=new_gen,
                seg_counter=counter,
                segments=committed + new_infos,
            )
            # two-phase publication (reference: formats_10.cpp:2826-2981)
            pending_name = f"pending_segments_{new_gen}"
            self._dir.write(pending_name, new_meta.to_bytes())
            self._dir.sync(new_files + [pending_name])
            self._dir.rename(pending_name, f"segments_{new_gen}")
            self._meta = new_meta
            clean_directory(self._dir, new_meta.referenced_files())
            log.info(
                "commit gen=%d: %d segment(s), %d live docs",
                new_gen,
                len(new_meta.segments),
                sum(i.num_docs for i in new_meta.segments),
            )
            return True

    def rollback(self) -> None:
        """Drop all uncommitted state (reference: IndexWriter::Rollback)."""
        with self._mutex:
            self._pending = _PendingSegment()
            self._flushed = []
            self._flushed_ticks = []
            self._removes = []

    def consolidate(self, policy=None) -> bool:
        """Merge committed segments chosen by ``policy`` into one segment.

        Reference: IndexWriter::Consolidate (index_writer.cpp:1340) with
        policies from core/utils/index_utils.hpp:32-84.

        Concurrency: the merge itself runs against a committed snapshot
        with NO locks held — inserts and commits proceed while it runs.
        Publication takes _commit_lock, re-validates the candidates
        against the then-current meta, and remaps deletes that landed
        during the merge through the merge's doc maps (reference:
        concurrent Consolidate + CandidateMapping,
        index_writer.cpp:1340,388-400). If a concurrent consolidation
        already merged away a candidate, this one aborts (returns False).
        """
        from iresearch_tpu_torch.index.consolidate import consolidate_tier
        from iresearch_tpu_torch.index.merge import merge_segments
        from iresearch_tpu_torch.index.reader import _read_mask

        # snapshot phase (lock-free): policy + merge on a committed gen
        reader = DirectoryReader.open(self._dir)
        if len(reader.segments) <= 1:
            return False
        policy = policy or consolidate_tier
        candidate_idx = policy(reader)
        if len(candidate_idx) <= 1:
            return False
        cand_set = set(candidate_idx)
        cand_infos = [reader.meta.segments[i] for i in candidate_idx]
        cand_readers = [reader.segments[i] for i in candidate_idx]
        with scoped_timer("writer.consolidate_merge"):
            merged, doc_maps = merge_segments(
                cand_readers, sort=self._opts.sort, return_doc_maps=True
            )

        # publication phase: validate + remap + atomic generation swap
        with self._commit_lock:
            meta = self._meta
            by_name = {info.name: info for info in meta.segments}
            extra_del = np.zeros(merged.num_docs, np.bool_)
            for info, sr, dmap in zip(cand_infos, cand_readers, doc_maps):
                cur = by_name.get(info.name)
                if cur is None:
                    return False  # lost the race to another consolidation
                if cur.del_gen != info.del_gen:
                    # deletes landed during the merge: remap them into the
                    # merged segment through this input's doc map
                    deleted_now = _read_mask(self._dir, cur)
                    if deleted_now is not None and len(deleted_now):
                        new_ids = dmap[deleted_now]
                        extra_del[new_ids[new_ids >= 0]] = True
            keep_infos = [
                info for info in meta.segments if info.name not in
                {ci.name for ci in cand_infos}
            ]
            new_gen = meta.gen + 1
            counter = meta.seg_counter + 1
            name = f"_{counter}"
            info = SegmentInfo(name, f"{name}.seg", merged.num_docs)
            new_files = [info.file]
            self._dir.write(
                info.file,
                write_segment(merged, version=self._opts.format_version),
            )
            if extra_del.any():
                info.del_gen = 1
                info.del_file = f"{name}_1.del"
                w = BlobPackWriter()
                w.add("docs", np.flatnonzero(extra_del).astype(np.uint32))
                self._dir.write(info.del_file, w.tobytes())
                new_files.append(info.del_file)
            segs = keep_infos + [info]
            new_meta = IndexMeta(gen=new_gen, seg_counter=counter, segments=segs)
            pending_name = f"pending_segments_{new_gen}"
            self._dir.write(pending_name, new_meta.to_bytes())
            self._dir.sync(new_files + [pending_name])
            self._dir.rename(pending_name, f"segments_{new_gen}")
            self._meta = new_meta
            clean_directory(self._dir, new_meta.referenced_files())
            return True

    def close(self) -> None:
        self._lock.release()

    def __enter__(self) -> "IndexWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
