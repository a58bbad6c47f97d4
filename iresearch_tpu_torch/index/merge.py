"""Segment merging for consolidation.

Reference: core/index/merge_writer.{hpp,cpp} — k-way merge of segment
readers remapping doc ids (dropping masked docs), union of term postings,
column remap. Here the merge is vectorized: decode every entry of each
segment at once, remap docs/terms with numpy, stable-sort by merged term id
(doc order is preserved because segment doc ranges are disjoint and
ascending), and re-encode through the standard block-pool encoder.

A copy of ``iresearch_tpu/index/merge.py``; its ``_decode_all_entries`` is
the one in ``formats/postings.py``.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from iresearch_tpu_torch.formats.columnstore import column_from_parts, column_parts
from iresearch_tpu_torch.formats.postings import (
    FieldPostings,
    _decode_all_entries,
    encode_field_postings,
)
from iresearch_tpu_torch.formats.spec import TermCols
from iresearch_tpu_torch.index.segment import SegmentData, SegmentReader


def merge_segments(
    readers: List[SegmentReader], sort=None, return_doc_maps: bool = False
):
    """Merge segments into one, dropping masked docs and remapping ids.

    ``sort`` (an index.writer.SortSpec) re-applies the primary sort to the
    merged doc ids (reference: merge_writer honors the comparator).
    ``return_doc_maps``: also return the per-input old->new doc maps
    (-1 = dropped), used by concurrent consolidation to remap deletes that
    landed while the merge ran (reference: CandidateMapping,
    index_writer.cpp:388-400).
    """
    # doc id remap: alive docs numbered sequentially across segments
    doc_maps = []
    new_num_docs = 0
    for sr in readers:
        alive = sr.alive
        m = np.full(sr.num_docs, -1, np.int64)
        idx = np.flatnonzero(alive)
        m[idx] = new_num_docs + np.arange(len(idx))
        new_num_docs += len(idx)
        doc_maps.append(m)

    if sort is not None and new_num_docs > 1:
        # compose the alive-compaction maps with the sort permutation
        values = {}
        for sr, dmap in zip(readers, doc_maps):
            col = sr.data.columns.get(sort.field)
            if col is None:
                continue
            for doc, value in col.items():
                nd = int(dmap[doc])
                if nd >= 0:
                    values[nd] = value
        keyfn = sort.key or (lambda b: b)

        def _key(nid):
            v = values.get(nid)
            return (v is None, keyfn(v) if v is not None else None)

        order = sorted(range(new_num_docs), key=_key, reverse=sort.descending)
        if sort.descending:  # missing-value docs always sort last
            order = [d for d in order if d in values] + [
                d for d in order if d not in values
            ]
        perm = np.empty(new_num_docs, np.int64)
        perm[np.asarray(order)] = np.arange(new_num_docs)
        doc_maps = [
            np.where(m >= 0, perm[np.maximum(m, 0)], -1) for m in doc_maps
        ]

    field_names = sorted({n for sr in readers for n in sr.data.fields})
    out_fields: Dict[str, FieldPostings] = {}
    for fname in field_names:
        merged = _merge_field(readers, doc_maps, fname, new_num_docs)
        if merged is not None:
            out_fields[fname] = merged

    # columns: vectorized remap + k-way concat + one argsort per column
    # (reference: merge_writer.cpp column merge; no per-doc Python)
    col_names = sorted({n for sr in readers for n in sr.data.columns})
    out_columns = {}
    for cname in col_names:
        part_docs, part_lens, part_blobs = [], [], []
        for sr, dmap in zip(readers, doc_maps):
            col = sr.data.columns.get(cname)
            if col is None:
                continue
            d, l, b = column_parts(col, dmap)
            part_docs.append(d)
            part_lens.append(l)
            part_blobs.append(np.frombuffer(b, np.uint8))
        docs = np.concatenate(part_docs) if part_docs else np.zeros(0, np.uint32)
        lens = np.concatenate(part_lens) if part_lens else np.zeros(0, np.int64)
        blob_arr = (
            np.concatenate(part_blobs) if part_blobs else np.zeros(0, np.uint8)
        )
        order = np.argsort(docs, kind="stable")
        starts = np.zeros(len(lens), np.int64)
        if len(lens):
            np.cumsum(lens[:-1], out=starts[1:])
        lens_o = lens[order]
        total = int(lens_o.sum())
        if total:
            within = np.arange(total, dtype=np.int64) - np.repeat(
                np.cumsum(lens_o) - lens_o, lens_o
            )
            blob = blob_arr[np.repeat(starts[order], lens_o) + within].tobytes()
        else:
            blob = b""
        out_columns[cname] = column_from_parts(
            docs[order], lens_o, blob, new_num_docs
        )

    data = SegmentData(new_num_docs, out_fields, out_columns)
    if return_doc_maps:
        return data, doc_maps
    return data


def _maps_monotone(doc_maps: List[np.ndarray]) -> bool:
    """True when every kept doc id ascends in old-doc order — the
    no-custom-sort case, where merged (term, doc) order equals
    per-segment order concatenated (segments' remapped ranges are
    disjoint ascending)."""
    for m in doc_maps:
        kept = m[m >= 0]
        if len(kept) > 1 and not bool((np.diff(kept) > 0).all()):
            return False
    return True


def _merge_field_native(
    readers: List[SegmentReader],
    doc_maps: List[np.ndarray],
    fname: str,
    new_num_docs: int,
    merged_terms: List[bytes],
    index: Dict[bytes, int],
    term_lists: List[List[bytes]],
) -> Optional[FieldPostings]:
    """Native streaming merge (iresearch_native.cpp:irs_merge_decode).

    One C++ pass per segment decodes+remaps+compacts its postings; doc
    order within each merged term is the segment concatenation order
    (exact when doc maps are monotone — checked by the caller), so the
    placement is a vectorized counting scatter with NO sort at all
    (the numpy path pays a 2-key lexsort over every entry). Positions/
    offsets/payloads gather by runs straight from the packed pools into
    the merged flat layout. Output is byte-identical to the numpy path
    (test_merge_native). Returns None to fall back (native lib absent,
    mixed feature presence, IRS_MERGE_NATIVE=0).

    Reference: merge_writer.cpp treats this as the HOT path (SURVEY
    §3.6); per-segment decodes run on a thread pool like the
    reference's concurrent consolidations.
    """
    import os as _os

    if _os.environ.get("IRS_MERGE_NATIVE", "1") == "0":
        return None
    from iresearch_tpu_torch import native as _native

    if _native.load() is None or getattr(
        _native.load(), "irs_merge_decode", None
    ) is None:
        return None
    parts = []  # (fp, dmap, terms)
    for sr, dmap, terms in zip(readers, doc_maps, term_lists):
        fp = sr.data.fields.get(fname)
        if fp is not None:
            parts.append((fp, dmap, terms))
    if not parts:
        return None
    # uniform feature presence only (mixed-presence unions stay numpy)
    has_pos = {fp.has_positions for fp, _, _ in parts}
    has_offs = {fp.offs_start is not None for fp, _, _ in parts}
    has_pays = {fp.pay_len is not None for fp, _, _ in parts}
    if len(has_pos) != 1 or len(has_offs) != 1 or len(has_pays) != 1:
        return None
    has_pos, has_offs, has_pays = has_pos.pop(), has_offs.pop(), has_pays.pop()

    Tm = len(merged_terms)
    new_norms = np.zeros(new_num_docs, np.uint32)
    features = parts[0][0].features

    def decode_one(args):
        fp, dmap, terms = args
        tid_remap = np.fromiter(
            (index[t] for t in terms), np.int64, count=len(terms)
        )
        e_cap = int(fp.entries[:, TermCols.DF].astype(np.int64).sum())
        return _native.merge_decode(
            fp.entries, fp.doc_words, fp.base, fp.freq_words,
            dmap.astype(np.int64, copy=False), tid_remap, e_cap,
        )

    if len(parts) > 1:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=len(parts)) as ex:
            decoded = list(ex.map(decode_one, parts))
    else:
        decoded = [decode_one(parts[0])]
    if any(d is None for d in decoded):
        return None

    # vectorized counting placement: dst of entry j of segment s =
    # term_ptr[tid] + (kept entries of tid in earlier segments) + rank of
    # j within its (segment, tid) run — no sort anywhere
    counts = [
        np.bincount(d[0], minlength=Tm).astype(np.int64) for d in decoded
    ]
    df2 = np.zeros(Tm, np.int64)
    for c in counts:
        df2 += c
    term_ptr = np.zeros(Tm + 1, np.int64)
    np.cumsum(df2, out=term_ptr[1:])
    E = int(term_ptr[-1])
    e_doc = np.empty(E, np.uint32)
    e_freq = np.empty(E, np.uint32)
    prior = np.zeros(Tm, np.int64)
    dsts = []
    for (tid_s, doc_s, freq_s, _orig, _po), counts_s in zip(decoded, counts):
        run_start = np.cumsum(counts_s) - counts_s
        rank = np.arange(len(tid_s), dtype=np.int64) - run_start[tid_s]
        dst = term_ptr[tid_s] + prior[tid_s] + rank
        e_doc[dst] = doc_s
        e_freq[dst] = freq_s
        prior += counts_s
        dsts.append(dst)
    for fp, dmap, _terms in parts:
        keep_norm = dmap >= 0
        new_norms[dmap[keep_norm]] = fp.norms[keep_norm]

    pos_flat = None
    offs = pays = None
    if has_pos:
        pos_ptr = np.zeros(E + 1, np.int64)
        np.cumsum(e_freq.astype(np.int64), out=pos_ptr[1:])
        P = int(pos_ptr[-1])
        pos_flat = np.empty(P, np.uint32)
        if has_offs:
            o_start = np.empty(P, np.uint32)
            o_end = np.empty(P, np.uint32)
        if has_pays:
            pay_len = np.empty(P, np.uint32)
        for (fp, _dmap, _terms), d, dst in zip(parts, decoded, dsts):
            _tid_s, _doc_s, freq_s, orig_s, posoff_s = d
            ttf = fp.entries[:, TermCols.TTF].astype(np.int64)
            tid_pos_base = np.zeros(len(ttf), np.int64)
            if len(ttf):
                np.cumsum(ttf[:-1], out=tid_pos_base[1:])
            dst_off = pos_ptr[dst]
            _native.merge_gather_pos(
                fp.entries, fp.pos_words, tid_pos_base, orig_s,
                posoff_s, freq_s, dst_off, pos_flat,
            )
            if has_offs:
                _native.copy_runs_u32(
                    fp.offs_start, posoff_s, dst_off, freq_s, o_start
                )
                _native.copy_runs_u32(
                    fp.offs_end, posoff_s, dst_off, freq_s, o_end
                )
            if has_pays:
                _native.copy_runs_u32(
                    fp.pay_len, posoff_s, dst_off, freq_s, pay_len
                )
        if has_offs:
            offs = (o_start, o_end)
        if has_pays:
            bptr = np.zeros(P + 1, np.int64)
            np.cumsum(pay_len.astype(np.int64), out=bptr[1:])
            blob_out = np.empty(int(bptr[-1]), np.uint8)
            for (fp, _dmap, _terms), d, dst in zip(parts, decoded, dsts):
                _tid_s, _doc_s, freq_s, _orig_s, posoff_s = d
                pptr = np.zeros(len(fp.pay_len) + 1, np.int64)
                np.cumsum(fp.pay_len.astype(np.int64), out=pptr[1:])
                src_b = pptr[posoff_s]
                len_b = pptr[posoff_s + freq_s.astype(np.int64)] - src_b
                dst_b = bptr[pos_ptr[dst]]
                _native.copy_runs_bytes(
                    np.frombuffer(fp.pay_blob, np.uint8), src_b, dst_b,
                    len_b, blob_out,
                )
            pays = (pay_len, blob_out.tobytes())

    # drop terms that lost all postings to doc masks (same as numpy path)
    keep_terms = np.flatnonzero(df2 > 0)
    if len(keep_terms) < Tm:
        kept = [merged_terms[i] for i in keep_terms]
        new_ptr = np.zeros(len(kept) + 1, np.int64)
        np.cumsum(df2[keep_terms], out=new_ptr[1:])
        merged_terms = kept
        term_ptr = new_ptr

    blob = b"".join(merged_terms)
    offsets = np.zeros(len(merged_terms) + 1, np.uint64)
    np.cumsum([len(t) for t in merged_terms], out=offsets[1:])
    from iresearch_tpu_torch.formats.spec import IndexFeatures

    return encode_field_postings(
        e_doc,
        e_freq,
        term_ptr,
        blob,
        offsets,
        new_norms,
        pos_flat=pos_flat,
        features=features if features is not None else IndexFeatures.FREQ,
        offs=offs,
        pays=pays,
    )


def _merge_field(
    readers: List[SegmentReader],
    doc_maps: List[np.ndarray],
    fname: str,
    new_num_docs: int,
) -> Optional[FieldPostings]:
    # merged sorted term dictionary
    term_lists = []
    for sr in readers:
        fp = sr.data.fields.get(fname)
        term_lists.append(sr.terms(fname) if fp is not None else [])
    merged_terms = sorted(set().union(*term_lists)) if term_lists else []
    index = {t: i for i, t in enumerate(merged_terms)}

    if merged_terms and _maps_monotone(doc_maps):
        out = _merge_field_native(
            readers, doc_maps, fname, new_num_docs,
            merged_terms, index, term_lists,
        )
        if out is not None:
            return out

    all_tid = []
    all_doc = []
    all_freq = []
    all_pos = []
    all_ostart: List[np.ndarray] = []
    all_oend: List[np.ndarray] = []
    all_paylen: List[np.ndarray] = []
    all_pay: List[bytes] = []
    new_norms = np.zeros(new_num_docs, np.uint32)
    features = None
    for sr, dmap, terms in zip(readers, doc_maps, term_lists):
        fp = sr.data.fields.get(fname)
        if fp is None:
            continue
        features = fp.features if features is None else features
        keep_norm = dmap >= 0
        new_norms[dmap[keep_norm]] = fp.norms[keep_norm]
        tid_of_entry, e_doc, e_freq, pos_off = _decode_all_entries(fp)
        remap = np.fromiter((index[t] for t in terms), np.int64, count=len(terms))
        new_doc = dmap[e_doc]
        keep = new_doc >= 0
        all_tid.append(remap[tid_of_entry[keep]])
        all_doc.append(new_doc[keep].astype(np.uint32))
        kept_freq = e_freq[keep]
        all_freq.append(kept_freq)
        if fp.has_positions:
            # decode the packed pools back to the flat rank order once,
            # then gather surviving entries' runs (v4: positions_flat)
            seg_pos = fp.positions_flat()
            starts = pos_off[keep]
            lens = kept_freq.astype(np.int64)
            total = int(lens.sum())
            if total:
                within = np.arange(total) - np.repeat(np.cumsum(lens) - lens, lens)
                idx = np.repeat(starts, lens) + within
                all_pos.append(seg_pos[idx])
                # position-parallel aux streams gather with the same index
                if fp.offs_start is not None:
                    all_ostart.append(fp.offs_start[idx])
                    all_oend.append(fp.offs_end[idx])
                if fp.pay_len is not None:
                    all_paylen.append(fp.pay_len[idx])
                    pptr = np.zeros(len(fp.pay_len) + 1, np.int64)
                    np.cumsum(fp.pay_len, out=pptr[1:])
                    all_pay.extend(
                        fp.pay_blob[pptr[i] : pptr[i + 1]] for i in idx
                    )
            else:
                all_pos.append(np.zeros(0, np.uint32))

    if not all_tid:
        return None
    tid = np.concatenate(all_tid)
    doc = np.concatenate(all_doc)
    freq = np.concatenate(all_freq)
    # (tid, doc) lexicographic order; doc ranges may interleave across
    # segments once a sort permutation is applied, so a full lexsort is
    # required (last lexsort key is primary)
    order = np.lexsort((doc, tid))
    tid_s = tid[order]
    e_doc = doc[order]
    e_freq = freq[order]
    term_ptr = np.zeros(len(merged_terms) + 1, np.int64)
    np.add.at(term_ptr, tid_s + 1, 1)
    np.cumsum(term_ptr, out=term_ptr)

    pos_flat = None
    offs = pays = None
    if all_pos:
        pos_cat = np.concatenate(all_pos) if all_pos else np.zeros(0, np.uint32)
        lens = freq.astype(np.int64)
        starts = np.zeros(len(lens), np.int64)
        if len(lens):
            np.cumsum(lens[:-1], out=starts[1:])
        lens_o = lens[order]
        starts_o = starts[order]
        total = int(lens_o.sum())
        if total:
            within = np.arange(total) - np.repeat(np.cumsum(lens_o) - lens_o, lens_o)
            fidx = np.repeat(starts_o, lens_o) + within
            pos_flat = pos_cat[fidx]
            if all_ostart:
                offs = (
                    np.concatenate(all_ostart)[fidx],
                    np.concatenate(all_oend)[fidx],
                )
            if all_paylen:
                pay_sorted = [all_pay[i] for i in fidx]
                pays = (
                    np.concatenate(all_paylen)[fidx],
                    b"".join(pay_sorted),
                )
        else:
            pos_flat = np.zeros(0, np.uint32)

    # drop terms that lost all postings to doc masks
    df = np.diff(term_ptr)
    keep_terms = np.flatnonzero(df > 0)
    if len(keep_terms) < len(merged_terms):
        kept = [merged_terms[i] for i in keep_terms]
        new_ptr = np.zeros(len(kept) + 1, np.int64)
        np.cumsum(df[keep_terms], out=new_ptr[1:])
        merged_terms = kept
        term_ptr = new_ptr

    blob = b"".join(merged_terms)
    offsets = np.zeros(len(merged_terms) + 1, np.uint64)
    np.cumsum([len(t) for t in merged_terms], out=offsets[1:])
    from iresearch_tpu_torch.formats.spec import IndexFeatures

    return encode_field_postings(
        e_doc,
        e_freq,
        term_ptr,
        blob,
        offsets,
        new_norms,
        pos_flat=pos_flat,
        features=features if features is not None else IndexFeatures.FREQ,
        offs=offs,
        pays=pays,
    )
