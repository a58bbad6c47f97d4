"""Device phrase execution: positional intersection as sorted-key set ops
(``exec/phrase.py``).

Reference: by_phrase executes as a conjunction wrapped in a position
checker that leapfrogs per-part position iterators doc by doc
(core/search/phrase_iterator.hpp:75-160). This formulation processes ALL
docs at once: each part's (doc, position - offset) pairs become sorted
int32 keys ``doc * pos_cap + shifted_pos``; the phrase hits are the keys of
part 0 that appear in every other part (``searchsorted`` membership);
per-doc tf = number of surviving keys, scored like a term with the
summed-idf weight (phrase stats, bm25.cpp:366-384).

Constraints for the device path (else the host evaluates the leaf):
single-term parts, positions present, and doc * pos_cap fitting int31
(nd_pad * pos_cap < 2^31).

The host half (``compile_phrase``, ``compile_phrase_keys``) is a copy of
the JAX package's. The device half is plain functions on tensors with an
explicit device: a part's docs and freqs decode through K3
(``kern.decode``: the kernel on the card, its plain version on the CPU),
positions unpack with ``unpack_torch``, and the key sort, the membership
search, the per-doc count and the score are PyTorch operations, as they
were XLA operations outside any Pallas kernel on the TPU. K3 returns freqs
as f32, which is exact below 2^24 (a freq is at most its doc's length).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from iresearch_tpu_torch.formats.bitpack import BITS, unpack_torch
from iresearch_tpu_torch.formats.spec import TermCols
from iresearch_tpu_torch.search.scorers import Scorer, f32, score_block_torch

_I32_MAX = 2**31 - 1


@dataclass
class PhrasePartSpec:
    """Device inputs for one single-term phrase part."""

    dcls: int
    fcls: int
    pcls: int
    rows_d: np.ndarray  # i32 [NB_pad]
    rows_f: np.ndarray  # i32 [NB_pad]
    rows_p: np.ndarray  # i32 [NPB_pad] rows into the class-pcls pos pool
    ttf: int
    offset: int
    # the part's own field (BySamePosition joins across fields,
    # same_position_filter.hpp — pools come from here)
    field_name: str = ""


@dataclass
class DevicePhraseSpec:
    field_name: str
    parts: List[PhrasePartSpec]
    weight: float  # term_weight(boost, summed idf)
    avgdl: float


def _pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def compile_phrase(
    flt, sr, seg_idx: int, boost: float, prepared, scorer: Scorer
) -> Optional[DevicePhraseSpec]:
    """Build a device spec for a ByPhrase of plain terms or a
    BySamePosition (offset-0 join across fields,
    same_position_filter.hpp), or None for host fallback."""
    from iresearch_tpu_torch.search import filters as F

    if isinstance(flt, F.BySamePosition):
        if not flt.terms:
            return None
        raw_parts = [(0, fld, F.PhraseTerm(t)) for fld, t in flt.terms]
    elif isinstance(flt, F.ByPhrase) and flt.parts:
        raw_parts = [(off, flt.field, p) for off, p in flt.parts]
    else:
        return None
    score_field = raw_parts[0][1]
    fp0 = sr.field(score_field)
    if fp0 is None:
        return None
    nd_pad = _pow2(max(1, sr.num_docs))
    pos_cap = 1
    for _off, fld, _p in raw_parts:
        fpx = sr.field(fld)
        if fpx is None or not fpx.has_positions:
            return None
        pos_cap = max(pos_cap, _pow2(int(fpx.norms.max(initial=1)) + 1))
    if nd_pad * pos_cap >= 2**31:
        return None
    dwf, ttf_field = prepared._field(score_field)
    avgdl = (ttf_field / dwf) if dwf else 1.0
    parts: List[PhrasePartSpec] = []
    idf_sum = 0.0
    for off, fld, p in raw_parts:
        if not isinstance(p, F.PhraseTerm):
            return None
        fp = sr.field(fld)
        tid = sr.lookup_term(fld, p.term)
        if tid is None:
            return None  # a missing part -> empty result; host handles it
        e = fp.entries[tid]
        nb = int(e[TermCols.NBLOCKS])
        nbp = _pow2(max(8, nb))
        rows_d = np.zeros(nbp, np.int32)
        rows_d[:nb] = np.arange(
            int(e[TermCols.DSTART]), int(e[TermCols.DSTART]) + nb, dtype=np.int32
        )
        rows_f = np.zeros(nbp, np.int32)
        rows_f[:nb] = np.arange(
            int(e[TermCols.FSTART]), int(e[TermCols.FSTART]) + nb, dtype=np.int32
        )
        ttf = int(e[TermCols.TTF])
        npb = (ttf + 127) >> 7
        npbp = _pow2(max(1, npb))
        rows_p = np.zeros(npbp, np.int32)  # pad -> sentinel row 0
        rows_p[:npb] = np.arange(
            int(e[TermCols.PSTART]), int(e[TermCols.PSTART]) + npb, dtype=np.int32
        )
        parts.append(
            PhrasePartSpec(
                dcls=int(e[TermCols.DCLS]),
                fcls=int(e[TermCols.FCLS]),
                pcls=int(e[TermCols.PCLS]),
                rows_d=rows_d,
                rows_f=rows_f,
                rows_p=rows_p,
                ttf=ttf,
                offset=int(off),
                field_name=fld,
            )
        )
        # index-wide df of the part's term (host prepare semantics)
        df = 0
        for sr2 in prepared.segments:
            fp2 = sr2.field(fld)
            tid2 = sr2.lookup_term(fld, p.term)
            if fp2 is not None and tid2 is not None:
                df += int(fp2.entries[tid2, TermCols.DF])
        idf_sum += scorer.idf(max(df, 1), max(dwf, 1))
    w = float(scorer.term_weight(boost * flt.boost, idf_sum))
    return DevicePhraseSpec(score_field, parts, w, avgdl)


@dataclass
class PhraseKeysSpec:
    """Positional keys for one segment's phrase/same-position aux leaf.

    For the sharded executor (``parallel/sharded.py``): the host decodes
    each part's (doc, position - offset) pairs into sorted int64 keys
    ``doc * 2^32 + shifted_pos`` at prepare time (exactly the oracle's
    formulation, host_eval._eval_positional); the device intersects the
    parts, counts per-doc tf and scores (``phrase_rows``).
    Keys re-encode to i32 with a shard-uniform pos_cap before upload.
    """

    field_name: str  # scoring field (dl/norms source)
    part_keys64: List[np.ndarray]  # per part: sorted int64 doc*2^32+pos
    weight: float
    avgdl: float
    max_pos: int  # max shifted position over all parts (caplog source)


def compile_phrase_keys(
    flt, sr, seg_idx: int, boost: float, prepared, scorer: Scorer
) -> Optional[PhraseKeysSpec]:
    """Build the per-segment keys spec for ByPhrase/BySamePosition, or
    None when the involved fields lack positions. Empty parts produce
    empty key arrays (=> no matches in this segment), keeping the spec
    structure shard-invariant."""
    from iresearch_tpu_torch.formats.postings import decode_term, term_positions
    from iresearch_tpu_torch.search import filters as F
    from iresearch_tpu_torch.search.expand import expand_phrase_part

    if isinstance(flt, F.BySamePosition):
        parts = []
        for fld, t in flt.terms:
            tid = sr.lookup_term(fld, t)
            parts.append((0, fld, [] if tid is None else [tid]))
    elif isinstance(flt, F.ByPhrase):
        parts = [
            (off, flt.field, expand_phrase_part(p, flt.field, sr))
            for off, p in flt.parts
        ]
    else:
        return None
    if not parts:
        return None
    for _off, fld, _tids in parts:
        fp = sr.field(fld)
        if fp is not None and not fp.has_positions:
            return None
    score_field = parts[0][1]
    dwf, ttf_field = prepared._field(score_field)
    avgdl = (ttf_field / dwf) if dwf else 1.0
    cap = np.int64(1) << 32
    key_arrays: List[np.ndarray] = []
    max_pos = 0
    any_empty = any(not tids for _o, _f, tids in parts)
    idf_sum = 0.0
    for off, fld, tids in parts:
        fp = sr.field(fld)
        arrs = []
        if fp is not None and not any_empty:
            for tid in tids:
                docs, freqs = decode_term(fp, tid)
                flat = term_positions(fp, tid).astype(np.int64)
                doc_of_pos = np.repeat(docs.astype(np.int64), freqs)
                shifted = flat - off
                ok = shifted >= 0
                arrs.append(doc_of_pos[ok] * cap + shifted[ok])
        keys = (
            np.unique(np.concatenate(arrs))
            if arrs
            else np.zeros(0, np.int64)
        )
        if len(keys):
            # max over ALL keys' position field — the largest KEY belongs
            # to the largest doc, whose position need not be the largest
            max_pos = max(max_pos, int((keys & (cap - 1)).max()))
        key_arrays.append(keys)
        # stats exactly as the oracle: per-part df = index-wide df of the
        # terms this SEGMENT expanded (host_eval._phrase_part_df), so w
        # is segment-dependent and must stack per shard
        dwf_f, _ = prepared._field(fld)
        df = prepared._phrase_part_df(fld, tids, sr)
        idf_sum += scorer.idf(max(df, 1), max(dwf_f, 1))
    w = float(scorer.term_weight(boost * flt.boost, idf_sum))
    return PhraseKeysSpec(score_field, key_arrays, w, avgdl, max_pos)


def part_keys(pool, rows, gbits, ttf: int, off: int, pos_cap_log2: int, *, kern):
    """Sorted int32 keys ``(doc << pos_cap_log2) + (pos - off)`` of one
    part; invalid slots get I32_MAX (sorts last, never matches).

    pool: (doc_words, freq_words, base, pos_words); rows: (rows_d, rows_f,
    rows_p) int32 tensors; gbits: (bd, bf, bp). Docs and freqs decode in
    one call of K3's plain form (``kern.decode``), row-gather inputs;
    positions decode from the term's packed block rows, pure unpack."""
    doc_words, freq_words, base, pos_words = pool
    rows_d, rows_f, rows_p = rows
    bd, bf, bp = gbits
    docs, freqs = kern.decode(
        doc_words, freq_words, base, rows_d, rows_f, bd=bd, bf=bf
    )
    docs = docs.reshape(-1)
    # cumsum of int32 gives int64 unless told otherwise
    cumf = torch.cumsum(freqs.reshape(-1).to(torch.int32), 0, dtype=torch.int32)
    pos = unpack_torch(pos_words[rows_p.to(torch.int64)], bp).reshape(-1)
    n = pos.shape[0]
    i = torch.arange(n, dtype=torch.int32, device=pos.device)
    entry = torch.searchsorted(cumf, i, right=True)
    doc_of_pos = docs[torch.clamp(entry, max=docs.shape[0] - 1)]
    shifted = pos - off
    # padded rows_p point at sentinel row 0 and are cut by i < ttf
    valid = (i < ttf) & (shifted >= 0) & (shifted < (1 << pos_cap_log2))
    key = (doc_of_pos << pos_cap_log2) + shifted
    key = torch.where(valid, key, _I32_MAX)
    return torch.sort(key).values


def phrase_rows(keys, weight, norms, avgdl, *, scorer: Scorer, shift: int, nd: int):
    """(match bool [Q, nd], score f32 [Q, nd]) of phrases given as sorted
    int32 keys ``(doc << shift) + pos``, one ``[Q, NK]`` tensor per part,
    I32_MAX-padded: the keys of part 0 found in every later part are the
    hits, each doc's count of them its tf, scored like a term with
    ``weight`` f32 [Q] (``exec/phrase.py:_run_phrase`` from the
    intersection on, and the sharded executor's phrase-keys leaf)."""
    keys0 = keys[0]
    alive_keys = keys0 != _I32_MAX
    for kj in keys[1:]:
        idx = torch.searchsorted(kj, keys0)
        found = kj.gather(-1, torch.clamp(idx, max=kj.shape[-1] - 1)) == keys0
        alive_keys = alive_keys & found
    # dead keys add 0.0 at nd - 1; a live key's doc is a real doc < nd, so
    # no index reaches past its query's row (an out-of-range index is a
    # device assert). The counts are whole numbers below 2^24: the order
    # of the float adds cannot change them
    q = keys0.shape[0]
    row = torch.arange(q, dtype=torch.int64, device=keys0.device)[:, None] * nd
    doc_of_key = torch.where(alive_keys, keys0 >> shift, nd - 1).to(torch.int64) + row
    tf = torch.zeros(q * nd, dtype=torch.float32, device=keys0.device).index_add_(
        0, doc_of_key.reshape(-1), alive_keys.to(torch.float32).reshape(-1)
    ).reshape(q, nd)
    match = tf > 0
    sc = score_block_torch(
        scorer, weight.reshape(q, 1), tf, norms.reshape(1, -1), avgdl
    )
    return match, torch.where(match, sc, 0.0)


def run_phrase(
    pools,  # per part: (doc_words, freq_words, base, pos_words)
    rows,  # per part: (rows_d, rows_f, rows_p)
    ttfs,  # per part: int
    offs,  # per part: int
    weight,  # f32 scalar tensor
    avgdl,  # float or f32 scalar tensor
    norms,  # f32 [nd]
    *,
    gbits,  # per part: (doc_bits, freq_bits, pos_bits)
    scorer: Scorer,
    pos_cap_log2: int,
    nd: int,
    kern,
):
    """(match bool [nd], score f32 [nd]) of the phrase whose parts are
    given (``exec/phrase.py:_run_phrase``)."""
    keys = [
        part_keys(
            pools[j], rows[j], gbits[j], ttfs[j], offs[j], pos_cap_log2, kern=kern
        )[None]
        for j in range(len(pools))
    ]
    match, score = phrase_rows(
        keys, weight, norms, avgdl, scorer=scorer, shift=pos_cap_log2, nd=nd
    )
    return match[0], score[0]


def run_phrase_dense(
    spec: DevicePhraseSpec, sr, scorer: Scorer, nd_pad: int, *, device, kern=None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Execute on ``device`` -> (match bool [nd_pad], score f32 [nd_pad]),
    both on the device. ``kern`` is the kernel set (``KERNELS``, the
    default, or ``PLAIN`` of ``exec/executor.py``)."""
    from iresearch_tpu_torch.index.segment import device_state

    if kern is None:
        from iresearch_tpu_torch.exec.executor import KERNELS as kern

    st = device_state(sr, device)
    dfield = st.field(spec.field_name)
    pos_cap = 1
    for p in spec.parts:
        fpx = sr.field(p.field_name or spec.field_name)
        pos_cap = max(pos_cap, _pow2(int(fpx.norms.max(initial=1)) + 1))
    pos_cap_log2 = int(np.log2(pos_cap))

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dfield.device)

    pools, rows, gbits = [], [], []
    for p in spec.parts:
        dfield_p = st.field(p.field_name or spec.field_name)
        pools.append(
            (
                dfield_p.doc_words[p.dcls],
                dfield_p.freq_words[p.fcls],
                dfield_p.base[p.dcls],
                dfield_p.pos_words(p.pcls),
            )
        )
        rows.append((up(p.rows_d), up(p.rows_f), up(p.rows_p)))
        gbits.append((BITS[p.dcls], BITS[p.fcls], BITS[p.pcls]))
    return run_phrase(
        tuple(pools),
        tuple(rows),
        [p.ttf for p in spec.parts],
        [p.offset for p in spec.parts],
        torch.tensor(f32(spec.weight), dtype=torch.float32, device=dfield.device),
        f32(spec.avgdl),
        dfield.norms,
        gbits=tuple(gbits),
        scorer=scorer,
        pos_cap_log2=pos_cap_log2,
        nd=nd_pad,
        kern=kern,
    )
