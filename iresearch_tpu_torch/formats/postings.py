"""Host-side postings encoder/decoder for the bit-packed block format.

Reference behavior being matched (not mimicked structurally):
core/formats/formats_10.cpp:320-1030 — postings_writer emits 128-doc
delta blocks with per-block bitwidths, positions, and skip metadata;
core/formats/formats_10.cpp:2020-2425 — postings_reader decodes blocks and
prefix-sums deltas.

Here the whole field is encoded in one vectorized numpy pass into pow2-
bit-width classed word pools (formats/bitpack.py): doc-delta blocks and
freq blocks are classed independently per term. Row 0 of every pool is a
sentinel block (base=0, deltas=0, freqs=0): gather padding can point at
row 0 and contributes exactly zero score/zero matches, so jitted query
shapes can be bucket-padded without masks.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from iresearch_tpu_torch.formats.bitpack import (
    BITS,
    bits_class,
    pack_blocks,
    unpack_blocks,
    words_per_block,
)
from iresearch_tpu_torch.formats.spec import (
    BLOCK,
    NUM_CLASSES,
    NUM_TERM_COLS,
    IndexFeatures,
    TermCols,
)


@dataclass
class FieldPostings:
    """One field's complete inverted data for a segment (host numpy form)."""

    # term dictionary: sorted terms as a byte blob + offsets
    term_blob: bytes
    term_offsets: np.ndarray  # u64 [T+1]
    entries: np.ndarray  # u32 [T, NUM_TERM_COLS]
    # doc-delta pools per width class; row 0 of each is the zero sentinel
    doc_words: Tuple[np.ndarray, ...]  # u32 [rows_c, 4*BITS[c]]
    base: Tuple[np.ndarray, ...]  # u32 [rows_c] absolute first doc of block
    bmax: Tuple[np.ndarray, ...]  # u32 [rows_c] last doc id of block
    # freq pools per width class (independent row allocation)
    freq_words: Tuple[np.ndarray, ...]  # u32 [rows_c, 4*BITS[c]]
    bmaxf: Tuple[np.ndarray, ...]  # u32 [rows_c] max freq in block
    norms: np.ndarray  # u32 [num_docs] token count per doc (0 = no field)
    # format v4: positions bit-packed per term into classed block pools
    # (reference packs positions into 128-blocks, formats_10.cpp:325-333);
    # PCLS/PSTART term columns locate each term's run
    pos_words: Optional[Tuple[np.ndarray, ...]]  # u32 [prows_c, 4*BITS[c]]
    docs_with_field: int
    total_term_freq: int
    features: IndexFeatures
    # format v5: per-entry doc lengths in classed pools parallel to the
    # freq blocks (NCLS/NSTART columns). None for legacy v3/v4 segments —
    # the executor then falls back to the norms[docs] per-lane gather.
    nrm_words: Optional[Tuple[np.ndarray, ...]] = None
    # position-parallel auxiliary streams, flat in position rank order
    # (indexed by TermCols.POS_BASE; OFFS/PAY are rare enough to stay raw)
    offs_start: Optional[np.ndarray] = None  # u32 [sum ttf]
    offs_end: Optional[np.ndarray] = None  # u32 [sum ttf]
    pay_len: Optional[np.ndarray] = None  # u32 [sum ttf]
    pay_blob: bytes = b""  # concatenated payloads (offsets = cumsum(pay_len))

    @property
    def num_terms(self) -> int:
        return len(self.term_offsets) - 1

    @property
    def has_positions(self) -> bool:
        return self.pos_words is not None

    def term_bytes(self, tid: int) -> bytes:
        return self.term_blob[self.term_offsets[tid] : self.term_offsets[tid + 1]]

    def terms(self) -> List[bytes]:
        off = self.term_offsets
        return [bytes(self.term_blob[off[i] : off[i + 1]]) for i in range(self.num_terms)]

    def positions_flat(self) -> Optional[np.ndarray]:
        """Decode ALL positions back to the flat per-term rank order
        (the v3 on-disk layout; used by merge re-encoding and the v3
        format writer)."""
        if self.pos_words is None:
            return None
        T = self.num_terms
        ttf = self.entries[:, TermCols.TTF].astype(np.int64)
        total = int(ttf.sum())
        out = np.zeros(total, np.uint32)
        if total == 0:
            return out
        pcls = self.entries[:, TermCols.PCLS].astype(np.int64)
        pstart = self.entries[:, TermCols.PSTART].astype(np.int64)
        pos_base = np.zeros(T, np.int64)
        pos_base[1:] = np.cumsum(ttf)[:-1]
        tid_of = np.repeat(np.arange(T, dtype=np.int64), ttf)
        prank = np.arange(total, dtype=np.int64) - pos_base[tid_of]
        pblk = prank >> 7
        plane = prank & (BLOCK - 1)
        flat_idx = np.arange(total, dtype=np.int64)
        for c in range(NUM_CLASSES):
            sel = pcls[tid_of] == c
            if not sel.any():
                continue
            vals = unpack_blocks(self.pos_words[c], BITS[c])
            r = (pstart[tid_of] + pblk)[sel]
            out[flat_idx[sel]] = vals[r, plane[sel]]
        return out


def _empty_pools():
    dw, fw, nw, pb, pbm, pbmf = [], [], [], [], [], []
    for c in range(NUM_CLASSES):
        dw.append(np.zeros((1, words_per_block(BITS[c])), np.uint32))
        fw.append(np.zeros((1, words_per_block(BITS[c])), np.uint32))
        nw.append(np.zeros((1, words_per_block(BITS[c])), np.uint32))
        pb.append(np.zeros(1, np.uint32))
        pbm.append(np.zeros(1, np.uint32))
        pbmf.append(np.zeros(1, np.uint32))
    return dw, fw, nw, pb, pbm, pbmf


def _empty_pos_pools() -> Tuple[np.ndarray, ...]:
    return tuple(
        np.zeros((1, words_per_block(BITS[c])), np.uint32)
        for c in range(NUM_CLASSES)
    )


def pack_position_pools(
    pos_flat: np.ndarray, ttf: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, Tuple[np.ndarray, ...]]:
    """Bit-pack per-term position streams into classed 128-lane blocks.

    Positions are stored RAW (within-doc absolute), not delta-coded: with
    pow2 width classes the class of a typical delta equals the class of
    the raw value (both ~log2(doclen) bits), and raw values decode with a
    plain unpack — no segmented prefix-sum keyed by entry boundaries.
    Width class is chosen per TERM so one long-document outlier cannot
    widen the whole field.

    Args:
      pos_flat: u32 [sum ttf] positions grouped per term (entry order).
      ttf: [T] positions per term (>0 for every term).
    Returns (pcls u32 [T], pstart u32 [T], pools) with row 0 of each pool
    the zero sentinel.
    """
    ttf = np.asarray(ttf, np.int64)
    T = len(ttf)
    pos_flat = np.asarray(pos_flat, np.uint32)
    pos_base = np.zeros(T, np.int64)
    pos_base[1:] = np.cumsum(ttf)[:-1]
    max_pos = np.maximum.reduceat(pos_flat, pos_base) if len(pos_flat) else np.zeros(T, np.uint32)
    pcls = bits_class(max_pos).astype(np.uint32)
    npb = (ttf + BLOCK - 1) // BLOCK
    pstart = np.zeros(T, np.int64)
    prows = []
    for c in range(NUM_CLASSES):
        in_c = pcls == c
        nb_c = npb[in_c]
        pstart[in_c] = np.cumsum(nb_c) - nb_c + 1
        prows.append(int(nb_c.sum()) + 1)
    P = len(pos_flat)
    tid_of = np.repeat(np.arange(T, dtype=np.int64), ttf)
    prank = np.arange(P, dtype=np.int64) - pos_base[tid_of]
    pblk = prank >> 7
    plane = prank & (BLOCK - 1)
    # native one-pass scatter-pack (iresearch_native.cpp:irs_scatter_pack)
    # — skips the per-class mask + zeroed [rows,128] matrix round trips
    from iresearch_tpu_torch import native as _native

    nat = _native.scatter_pack(
        pos_flat,
        pstart[tid_of] + pblk,
        plane.astype(np.uint8),
        pcls[tid_of].astype(np.uint8),
        prows,
    )
    if nat is not None:
        return pcls, pstart.astype(np.uint32), nat
    pools = []
    for c in range(NUM_CLASSES):
        sel = pcls[tid_of] == c
        mat = np.zeros((prows[c], BLOCK), np.uint32)
        if sel.any():
            mat[(pstart[tid_of] + pblk)[sel], plane[sel]] = pos_flat[sel]
        pools.append(pack_blocks(mat, BITS[c]))
    return pcls, pstart.astype(np.uint32), tuple(pools)


def _encode_pools_class_numpy(
    c, dcls, fcls, ncls, tid_of_entry, dstart, fstart, nstart,
    blk_in_term, lane, delta, e_doc, e_freq, e_norm,
    drows, frows, nrows,
    pools_dw, pools_fw, pools_nw, pools_base, pools_bmax, pools_bmaxf,
):
    """Pure-numpy pool encode for one width class (fallback when the
    native scatter-pack kernel is unavailable; bit-identical output)."""
    b = BITS[c]
    # doc-delta pool
    sel = dcls[tid_of_entry] == c
    r = (dstart[tid_of_entry] + blk_in_term)[sel]
    ln = lane[sel]
    mat = np.zeros((drows[c], BLOCK), np.uint32)
    mat[r, ln] = delta[sel]
    pools_dw.append(pack_blocks(mat, b))
    pb = np.zeros(drows[c], np.uint32)
    is_base = ln == 0
    pb[r[is_base]] = e_doc[sel][is_base]
    pools_base.append(pb)
    pbm = np.zeros(drows[c], np.uint32)
    # docs ascend within each block row, so the row max is the LAST
    # entry of the row — one fancy assignment instead of maximum.at
    # (ufunc.at is ~us/element; it dominated 5M-doc encodes)
    docs_c = e_doc[sel]
    if len(r):
        is_last = np.empty(len(r), bool)
        np.not_equal(r[:-1], r[1:], out=is_last[:-1])
        is_last[-1] = True
        pbm[r[is_last]] = docs_c[is_last]
    pools_bmax.append(pbm)
    # freq pool
    self_f = fcls[tid_of_entry] == c
    rf = (fstart[tid_of_entry] + blk_in_term)[self_f]
    lnf = lane[self_f]
    matf = np.zeros((frows[c], BLOCK), np.uint32)
    matf[rf, lnf] = e_freq[self_f]
    pools_fw.append(pack_blocks(matf, b))
    pbmf = np.zeros(frows[c], np.uint32)
    # freqs are unordered within a row: segmented reduceat over the
    # row-run boundaries (rf is non-decreasing)
    freqs_c = e_freq[self_f]
    if len(rf):
        bnds = np.empty(len(rf), bool)
        bnds[0] = True
        np.not_equal(rf[1:], rf[:-1], out=bnds[1:])
        starts_rf = np.flatnonzero(bnds)
        pbmf[rf[starts_rf]] = np.maximum.reduceat(freqs_c, starts_rf)
    pools_bmaxf.append(pbmf)
    # norm pool (per-entry doc lengths; padding lanes stay 0 and are
    # gated by freq==0 in the executor)
    sel_n = ncls[tid_of_entry] == c
    rn = (nstart[tid_of_entry] + blk_in_term)[sel_n]
    matn = np.zeros((nrows[c], BLOCK), np.uint32)
    matn[rn, lane[sel_n]] = e_norm[sel_n]
    pools_nw.append(pack_blocks(matn, b))


def encode_field_postings(
    e_doc: np.ndarray,
    e_freq: np.ndarray,
    term_ptr: np.ndarray,
    term_blob: bytes,
    term_offsets: np.ndarray,
    norms: np.ndarray,
    pos_flat: Optional[np.ndarray] = None,
    features: IndexFeatures = IndexFeatures.FREQ | IndexFeatures.POS,
    offs: Optional[Tuple[np.ndarray, np.ndarray]] = None,
    pays: Optional[Tuple[np.ndarray, bytes]] = None,
) -> FieldPostings:
    """Encode one field's (term, doc, freq) entries into block pools.

    Args:
      e_doc/e_freq: per-entry doc id and frequency, sorted by (term, doc).
      term_ptr: i64 [T+1], entries of term ``t`` are ``[term_ptr[t], term_ptr[t+1])``.
      term_blob/term_offsets: the sorted term dictionary bytes.
      norms: u32 [num_docs] per-doc token counts for this field.
      pos_flat: flat positions grouped in entry order (len per entry == freq).
      offs: optional (start u32, end u32) arrays parallel to pos_flat (OFFS).
      pays: optional (pay_len u32 parallel to pos_flat, concatenated bytes).
    """
    e_doc = np.asarray(e_doc, dtype=np.uint32)
    e_freq = np.asarray(e_freq, dtype=np.uint32)
    term_ptr = np.asarray(term_ptr, dtype=np.int64)
    T = len(term_ptr) - 1
    E = len(e_doc)
    assert len(e_freq) == E
    # debug invariants (IRS_DEBUG=1; reference: IRS_ASSERT, assert.hpp)
    from iresearch_tpu_torch.utils.debug import assertions_enabled, irs_assert

    if assertions_enabled() and E:
        starts = term_ptr[:-1]
        within = np.ones(E, bool)
        within[starts[starts < E]] = False  # first entry of each term
        irs_assert(
            bool((np.diff(e_doc.astype(np.int64)) > 0)[within[1:]].all()),
            "postings docs must be strictly ascending within each term",
        )
        irs_assert(
            bool((term_ptr[1:] >= term_ptr[:-1]).all()),
            "term_ptr must be non-decreasing",
        )
    assert term_ptr[0] == 0 and term_ptr[-1] == E

    entries = np.zeros((T, NUM_TERM_COLS), dtype=np.uint32)
    norms_arr = np.asarray(norms, dtype=np.uint32)

    if T == 0 or E == 0:
        dw, fw, nw, pb, pbm, pbmf = _empty_pools()
        return FieldPostings(
            term_blob=term_blob,
            term_offsets=np.asarray(term_offsets, dtype=np.uint64),
            entries=entries,
            doc_words=tuple(dw),
            base=tuple(pb),
            bmax=tuple(pbm),
            freq_words=tuple(fw),
            bmaxf=tuple(pbmf),
            norms=norms_arr,
            nrm_words=tuple(nw),
            pos_words=None if pos_flat is None else _empty_pos_pools(),
            docs_with_field=int(np.count_nonzero(norms_arr)),
            total_term_freq=0,
            features=features,
            offs_start=None if offs is None else np.asarray(offs[0], np.uint32),
            offs_end=None if offs is None else np.asarray(offs[1], np.uint32),
            pay_len=None if pays is None else np.asarray(pays[0], np.uint32),
            pay_blob=b"" if pays is None else bytes(pays[1]),
        )

    df = np.diff(term_ptr)  # [T]
    assert (df > 0).all(), "terms with zero postings are not allowed"
    tid_of_entry = np.repeat(np.arange(T, dtype=np.int64), df)
    rank = np.arange(E, dtype=np.int64) - term_ptr[tid_of_entry]
    blk_in_term = rank >> 7
    lane = (rank & (BLOCK - 1)).astype(np.int64)

    prev_doc = np.empty_like(e_doc)
    prev_doc[0] = 0
    prev_doc[1:] = e_doc[:-1]
    # lane 0 is a block start: its doc goes to ``base`` and its delta is 0.
    delta = np.where(lane == 0, 0, e_doc - prev_doc).astype(np.uint32)

    starts = term_ptr[:-1]
    e_norm = norms_arr[e_doc]  # per-entry doc length (inline norms, v5)
    max_delta = np.maximum.reduceat(delta, starts)
    max_freq = np.maximum.reduceat(e_freq, starts)
    max_norm = np.maximum.reduceat(e_norm, starts)
    min_norm = np.minimum.reduceat(e_norm, starts)
    ttf = np.add.reduceat(e_freq.astype(np.uint64), starts)

    dcls = bits_class(max_delta).astype(np.uint32)
    fcls = bits_class(max_freq).astype(np.uint32)
    ncls = bits_class(max_norm).astype(np.uint32)
    nblocks = ((df + BLOCK - 1) // BLOCK).astype(np.int64)

    def alloc(cls_of_term):
        """Row allocation per class (row 0 reserved for the sentinel)."""
        start = np.zeros(T, dtype=np.int64)
        rows = []
        for c in range(NUM_CLASSES):
            in_c = cls_of_term == c
            nb_c = nblocks[in_c]
            start[in_c] = np.cumsum(nb_c) - nb_c + 1
            rows.append(int(nb_c.sum()) + 1)
        return start, rows

    dstart, drows = alloc(dcls)
    fstart, frows = alloc(fcls)
    nstart, nrows = alloc(ncls)

    pools_dw, pools_fw, pools_base, pools_bmax, pools_bmaxf = [], [], [], [], []
    pools_nw = []
    from iresearch_tpu_torch import native as _native

    lane8 = lane.astype(np.uint8)
    dcls_e = dcls[tid_of_entry].astype(np.uint8)
    drow = dstart[tid_of_entry] + blk_in_term
    nat_dw = _native.scatter_pack(delta, drow, lane8, dcls_e, drows)
    if nat_dw is not None:
        # native one-pass packing for the three word-pool families, plus
        # global-row (class-offset) scatters for base/bmax/bmaxf — no
        # per-class masks or zeroed [rows,128] matrices anywhere
        fcls_e = fcls[tid_of_entry].astype(np.uint8)
        ncls_e = ncls[tid_of_entry].astype(np.uint8)
        frow = fstart[tid_of_entry] + blk_in_term
        nrow = nstart[tid_of_entry] + blk_in_term
        pools_dw = list(nat_dw)
        pools_fw = list(
            _native.scatter_pack(e_freq, frow, lane8, fcls_e, frows)
        )
        pools_nw = list(
            _native.scatter_pack(e_norm, nrow, lane8, ncls_e, nrows)
        )
        doff = np.zeros(NUM_CLASSES + 1, np.int64)
        np.cumsum(drows, out=doff[1:])
        dgrow = doff[dcls_e] + drow  # global row id per entry
        pb_all = np.zeros(doff[-1], np.uint32)
        is_base = lane == 0
        pb_all[dgrow[is_base]] = e_doc[is_base]
        pbm_all = np.zeros(doff[-1], np.uint32)
        # docs ascend within each block row; rows of one term are
        # contiguous in entry order, so "last of its run" = row max
        is_last = np.empty(E, bool)
        np.not_equal(dgrow[:-1], dgrow[1:], out=is_last[:-1])
        is_last[-1] = True
        pbm_all[dgrow[is_last]] = e_doc[is_last]
        pools_base = [pb_all[doff[c] : doff[c + 1]] for c in range(NUM_CLASSES)]
        pools_bmax = [pbm_all[doff[c] : doff[c + 1]] for c in range(NUM_CLASSES)]
        foff = np.zeros(NUM_CLASSES + 1, np.int64)
        np.cumsum(frows, out=foff[1:])
        fgrow = foff[fcls_e] + frow
        pbmf_all = np.zeros(foff[-1], np.uint32)
        bnds = np.empty(E, bool)
        bnds[0] = True
        np.not_equal(fgrow[1:], fgrow[:-1], out=bnds[1:])
        starts_f = np.flatnonzero(bnds)
        pbmf_all[fgrow[starts_f]] = np.maximum.reduceat(e_freq, starts_f)
        pools_bmaxf = [
            pbmf_all[foff[c] : foff[c + 1]] for c in range(NUM_CLASSES)
        ]
    else:
        for c in range(NUM_CLASSES):
            _encode_pools_class_numpy(
                c, dcls, fcls, ncls, tid_of_entry, dstart, fstart, nstart,
                blk_in_term, lane, delta, e_doc, e_freq, e_norm,
                drows, frows, nrows,
                pools_dw, pools_fw, pools_nw,
                pools_base, pools_bmax, pools_bmaxf,
            )
    pos_base = np.zeros(T, dtype=np.uint64)
    pos_pools = None
    if pos_flat is not None:
        pos_base[1:] = np.cumsum(ttf)[:-1]
        assert int(ttf.sum()) == len(pos_flat), "positions must cover every freq"
        pcls, pstart, pos_pools = pack_position_pools(pos_flat, ttf)
        entries[:, TermCols.PCLS] = pcls
        entries[:, TermCols.PSTART] = pstart

    entries[:, TermCols.DF] = df.astype(np.uint32)
    entries[:, TermCols.TTF] = ttf.astype(np.uint32)
    entries[:, TermCols.DCLS] = dcls
    entries[:, TermCols.FCLS] = fcls
    entries[:, TermCols.DSTART] = dstart.astype(np.uint32)
    entries[:, TermCols.FSTART] = fstart.astype(np.uint32)
    entries[:, TermCols.NBLOCKS] = nblocks.astype(np.uint32)
    entries[:, TermCols.POS_BASE] = pos_base.astype(np.uint32)
    entries[:, TermCols.MAX_FREQ] = max_freq
    entries[:, TermCols.MIN_NORM] = min_norm
    entries[:, TermCols.NCLS] = ncls
    entries[:, TermCols.NSTART] = nstart.astype(np.uint32)

    return FieldPostings(
        term_blob=term_blob,
        term_offsets=np.asarray(term_offsets, dtype=np.uint64),
        entries=entries,
        doc_words=tuple(pools_dw),
        base=tuple(pools_base),
        bmax=tuple(pools_bmax),
        freq_words=tuple(pools_fw),
        bmaxf=tuple(pools_bmaxf),
        norms=norms_arr,
        nrm_words=tuple(pools_nw),
        pos_words=pos_pools,
        docs_with_field=int(np.count_nonzero(norms_arr)),
        total_term_freq=int(ttf.sum()),
        features=features,
        offs_start=None if offs is None else np.asarray(offs[0], np.uint32),
        offs_end=None if offs is None else np.asarray(offs[1], np.uint32),
        pay_len=None if pays is None else np.asarray(pays[0], np.uint32),
        pay_blob=b"" if pays is None else bytes(pays[1]),
    )


def derive_norm_pools(fp: FieldPostings) -> FieldPostings:
    """Rebuild inline norm pools for a legacy (v3/v4) field in place.

    Decodes every entry's doc id vectorized, gathers its doc length from
    the dense norms array, and packs the per-entry stream into classed
    block pools exactly as the encoder does — used by the v5 writer and
    format conversion. Returns ``fp`` with nrm_words/NCLS/NSTART set.
    """
    if fp.nrm_words is not None:
        return fp
    T = fp.num_terms
    entries = fp.entries
    if T == 0 or int(entries[:, TermCols.DF].sum()) == 0:
        fp.nrm_words = _empty_pos_pools()
        return fp
    tid_of_entry, e_doc, _e_freq, _ = _decode_all_entries(fp)
    e_norm = fp.norms[e_doc]
    df = entries[:, TermCols.DF].astype(np.int64)
    term_ptr = np.zeros(T + 1, np.int64)
    np.cumsum(df, out=term_ptr[1:])
    starts = term_ptr[:-1]
    max_norm = np.maximum.reduceat(e_norm, starts)
    ncls = bits_class(max_norm).astype(np.uint32)
    nblocks = ((df + BLOCK - 1) // BLOCK).astype(np.int64)
    nstart = np.zeros(T, np.int64)
    nrows = []
    for c in range(NUM_CLASSES):
        in_c = ncls == c
        nb_c = nblocks[in_c]
        nstart[in_c] = np.cumsum(nb_c) - nb_c + 1
        nrows.append(int(nb_c.sum()) + 1)
    rank = np.arange(len(e_doc), dtype=np.int64) - term_ptr[tid_of_entry]
    blk = rank >> 7
    lane = rank & (BLOCK - 1)
    pools = []
    for c in range(NUM_CLASSES):
        sel = ncls[tid_of_entry] == c
        mat = np.zeros((nrows[c], BLOCK), np.uint32)
        mat[(nstart[tid_of_entry] + blk)[sel], lane[sel]] = e_norm[sel]
        pools.append(pack_blocks(mat, BITS[c]))
    entries[:, TermCols.NCLS] = ncls
    entries[:, TermCols.NSTART] = nstart.astype(np.uint32)
    fp.nrm_words = tuple(pools)
    return fp


def _decode_all_entries(fp: FieldPostings):
    """Decode every posting entry of a field in one vectorized pass
    (a copy of ``iresearch_tpu/index/merge.py:_decode_all_entries``).

    Returns (tid_of_entry, e_doc, e_freq, pos_offsets) in entry order —
    entry order is (term asc, doc asc) by construction.
    """
    T = fp.num_terms
    if T == 0:
        z = np.zeros(0, np.int64)
        return z, z.astype(np.uint32), z.astype(np.uint32), z
    df = fp.entries[:, TermCols.DF].astype(np.int64)
    tid_of_entry = np.repeat(np.arange(T, dtype=np.int64), df)
    E = int(df.sum())
    e_doc = np.empty(E, np.uint32)
    e_freq = np.empty(E, np.uint32)
    # per-class vectorized block decode
    ptr = np.zeros(T + 1, np.int64)
    np.cumsum(df, out=ptr[1:])
    def scatter_decoded(cls_col, start_col, decode_rows, out):
        """Per-class vectorized decode of the valid prefix of each term."""
        for c in range(NUM_CLASSES):
            sel = np.flatnonzero(fp.entries[:, cls_col] == c)
            if len(sel) == 0:
                continue
            nb = fp.entries[sel, TermCols.NBLOCKS].astype(np.int64)
            b0 = fp.entries[sel, start_col].astype(np.int64)
            rows = np.repeat(b0, nb) + (
                np.arange(int(nb.sum())) - np.repeat(np.cumsum(nb) - nb, nb)
            )
            flat = decode_rows(c, rows).reshape(-1)
            term_df = df[sel]
            blk_base = np.repeat((np.cumsum(nb) - nb) * BLOCK, term_df)
            within = np.arange(int(term_df.sum())) - np.repeat(
                np.cumsum(term_df) - term_df, term_df
            )
            dst = np.repeat(ptr[sel], term_df) + within
            out[dst] = flat[blk_base + within].astype(np.uint32)

    def decode_docs(c, rows):
        deltas = unpack_blocks(fp.doc_words[c][rows], BITS[c]).astype(np.uint64)
        return fp.base[c][rows].astype(np.uint64)[:, None] + np.cumsum(deltas, axis=1)

    def decode_freqs(c, rows):
        return unpack_blocks(fp.freq_words[c][rows], BITS[c])

    scatter_decoded(TermCols.DCLS, TermCols.DSTART, decode_docs, e_doc)
    scatter_decoded(TermCols.FCLS, TermCols.FSTART, decode_freqs, e_freq)
    pos_off = np.zeros(E, np.int64)
    if E:
        np.cumsum(e_freq[:-1], out=pos_off[1:])
    return tid_of_entry, e_doc, e_freq, pos_off


def decode_term(fp: FieldPostings, tid: int) -> Tuple[np.ndarray, np.ndarray]:
    """Reference decoder (host oracle): absolute doc ids + freqs of one term."""
    e = fp.entries[tid]
    nb = int(e[TermCols.NBLOCKS])
    df = int(e[TermCols.DF])
    dc = int(e[TermCols.DCLS])
    d0 = int(e[TermCols.DSTART])
    d = unpack_blocks(fp.doc_words[dc][d0 : d0 + nb], BITS[dc]).astype(np.uint64)
    docs = fp.base[dc][d0 : d0 + nb].astype(np.uint64)[:, None] + np.cumsum(d, axis=1)
    fc = int(e[TermCols.FCLS])
    f0 = int(e[TermCols.FSTART])
    freqs = unpack_blocks(fp.freq_words[fc][f0 : f0 + nb], BITS[fc])
    return docs.reshape(-1)[:df].astype(np.uint32), freqs.reshape(-1)[:df]


def term_positions(fp: FieldPostings, tid: int) -> np.ndarray:
    """One term's full position stream (entry order) decoded from the
    packed pools."""
    assert fp.pos_words is not None
    e = fp.entries[tid]
    ttf = int(e[TermCols.TTF])
    c = int(e[TermCols.PCLS])
    p0 = int(e[TermCols.PSTART])
    nb = (ttf + BLOCK - 1) // BLOCK
    vals = unpack_blocks(fp.pos_words[c][p0 : p0 + nb], BITS[c])
    return vals.reshape(-1)[:ttf]


def decode_positions(fp: FieldPostings, tid: int) -> List[np.ndarray]:
    """Positions per posting entry of one term (host oracle)."""
    flat = term_positions(fp, tid)
    _, freqs = decode_term(fp, tid)
    out = []
    off = 0
    for f in freqs:
        out.append(flat[off : off + int(f)])
        off += int(f)
    return out


def decode_offsets(fp: FieldPostings, tid: int) -> List[np.ndarray]:
    """(start, end) offset pairs per posting entry, shape [freq, 2]."""
    assert fp.offs_start is not None and fp.offs_end is not None
    e = fp.entries[tid]
    _, freqs = decode_term(fp, tid)
    out = []
    off = int(e[TermCols.POS_BASE])
    for f in freqs:
        out.append(
            np.stack(
                [fp.offs_start[off : off + int(f)], fp.offs_end[off : off + int(f)]],
                axis=1,
            )
        )
        off += int(f)
    return out


def decode_payloads(fp: FieldPostings, tid: int) -> List[List[bytes]]:
    """Per-position payload bytes per posting entry of one term."""
    assert fp.pay_len is not None
    e = fp.entries[tid]
    _, freqs = decode_term(fp, tid)
    ptr = np.zeros(len(fp.pay_len) + 1, np.int64)
    np.cumsum(fp.pay_len, out=ptr[1:])
    out = []
    off = int(e[TermCols.POS_BASE])
    for f in freqs:
        row = [
            fp.pay_blob[ptr[i] : ptr[i + 1]] for i in range(off, off + int(f))
        ]
        out.append(row)
        off += int(f)
    return out
