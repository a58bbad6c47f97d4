"""ctypes loader for the native host library (native/iresearch_native.cpp).

A copy of ``iresearch_tpu/native.py``: the write-path tokenizer and term
dictionary, the fuzzy-expansion Levenshtein and DFA routines, the postings
scatter-pack, the dense-grid builder, the consolidation-merge kernels and
checksums. ``native/`` is the C++ library both packages share; it is built
on first use with ``make -C native`` when a compiler is available (the
``.so`` is not committed), and every caller keeps a pure-Python fallback
for when it is not.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_NATIVE_DIR = os.path.join(_REPO_ROOT, "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libiresearch_native.so")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _try_build() -> bool:
    try:
        r = subprocess.run(
            ["make", "-C", _NATIVE_DIR],
            capture_output=True,
            timeout=120,
        )
        return r.returncode == 0 and os.path.exists(_LIB_PATH)
    except Exception:
        return False


def load() -> Optional[ctypes.CDLL]:
    """The native library, building it on first use; None if unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not os.path.exists(_LIB_PATH) and os.path.isdir(_NATIVE_DIR):
            _try_build()
        if not os.path.exists(_LIB_PATH):
            return None
        try:
            lib = ctypes.CDLL(_LIB_PATH)
        except OSError:
            return None
        lib.irs_tokenize_ascii.restype = ctypes.c_int32
        lib.irs_tokenize_ascii.argtypes = [
            ctypes.c_char_p,
            ctypes.c_int32,
            ctypes.c_int32,
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int32,
        ]
        lib.irs_levenshtein_batch.restype = None
        lib.irs_levenshtein_batch.argtypes = [
            np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS"),
            ctypes.c_int32,
            np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            ctypes.c_int32,
            ctypes.c_int32,
            ctypes.c_int32,
            ctypes.c_int32,
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        ]
        try:
            lib.irs_dfa_intersect.restype = ctypes.c_int32
            lib.irs_dfa_intersect.argtypes = [
                ctypes.c_char_p,
                np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
                ctypes.c_int64,
                ctypes.c_int64,
                np.ctypeslib.ndpointer(np.uint16, flags="C_CONTIGUOUS"),
                np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
                np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
                ctypes.c_int32,
            ]
        except AttributeError:
            pass
        try:
            lib.irs_dfa_determinize.restype = ctypes.c_int32
            lib.irs_dfa_determinize.argtypes = [
                ctypes.c_int32,
                ctypes.c_int64,
                np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
                np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
                np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
                np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
                ctypes.c_int64,
                np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
                np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
                np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
                ctypes.c_int32,
                np.ctypeslib.ndpointer(np.uint16, flags="C_CONTIGUOUS"),
                np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
            ]
        except AttributeError:
            lib.irs_dfa_determinize = None
        try:
            lib.irs_lev_dfa_build.restype = ctypes.c_int32
            lib.irs_lev_dfa_build.argtypes = [
                np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS"),
                ctypes.c_int32,
                ctypes.c_int32,
                ctypes.c_int32,
                ctypes.c_char_p,
                ctypes.c_int32,
                ctypes.c_int32,
                np.ctypeslib.ndpointer(np.uint16, flags="C_CONTIGUOUS"),
                np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
            ]
        except AttributeError:
            lib.irs_lev_dfa_build = None
        lib.irs_crc32c.restype = ctypes.c_uint32
        lib.irs_crc32c.argtypes = [
            ctypes.c_char_p,
            ctypes.c_int64,
            ctypes.c_uint32,
        ]
        lib.irs_termdict_new.restype = ctypes.c_void_p
        lib.irs_termdict_free.argtypes = [ctypes.c_void_p]
        lib.irs_termdict_size.restype = ctypes.c_int32
        lib.irs_termdict_size.argtypes = [ctypes.c_void_p]
        lib.irs_termdict_add.restype = ctypes.c_int32
        lib.irs_termdict_add.argtypes = [
            ctypes.c_void_p,
            ctypes.c_char_p,
            ctypes.c_int32,
        ]
        lib.irs_termdict_bytes.restype = ctypes.c_int64
        lib.irs_termdict_bytes.argtypes = [ctypes.c_void_p]
        try:
            lib.irs_termdict_merge.restype = ctypes.c_int32
            lib.irs_termdict_merge.argtypes = [
                ctypes.c_void_p,
                ctypes.c_void_p,
                np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            ]
        except AttributeError:
            pass
        lib.irs_termdict_dump.argtypes = [
            ctypes.c_void_p,
            ctypes.c_char_p,
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        ]
        lib.irs_tokenize_to_tids.restype = ctypes.c_int32
        lib.irs_tokenize_to_tids.argtypes = [
            ctypes.c_void_p,
            ctypes.c_char_p,
            ctypes.c_int32,
            ctypes.c_int32,
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int32,
        ]
        # UTF-8 tokenizer (older .so builds lack it: rebuild, else skip)
        try:
            lib.irs_tokenize_to_tids_utf8.restype = ctypes.c_int32
            lib.irs_tokenize_to_tids_utf8.argtypes = [
                ctypes.c_void_p,
                ctypes.c_char_p,
                ctypes.c_int32,
                ctypes.c_int32,
                ctypes.c_int32,
                ctypes.POINTER(ctypes.c_int32),
                ctypes.c_int32,
            ]
        except AttributeError:
            lib.irs_tokenize_to_tids_utf8 = None
        # scatter-pack encoder kernel (older .so builds lack it)
        try:
            lib.irs_scatter_pack.restype = None
            lib.irs_scatter_pack.argtypes = [
                np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS"),
                np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
                np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
                np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
                ctypes.c_int64,
                ctypes.POINTER(ctypes.c_void_p),
            ]
        except AttributeError:
            lib.irs_scatter_pack = None
        # consolidation-merge kernels (older .so builds lack them)
        try:
            lib.irs_merge_decode.restype = ctypes.c_int64
            lib.irs_merge_decode.argtypes = [
                np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS"),
                ctypes.c_int64,
                ctypes.c_int64,
                ctypes.POINTER(ctypes.c_void_p),
                ctypes.POINTER(ctypes.c_void_p),
                ctypes.POINTER(ctypes.c_void_p),
                np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
                np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
                np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
                np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS"),
                np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS"),
                np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
                np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            ]
            lib.irs_merge_gather_pos.restype = None
            lib.irs_merge_gather_pos.argtypes = [
                np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS"),
                ctypes.c_int64,
                ctypes.POINTER(ctypes.c_void_p),
                np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
                np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
                np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
                np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS"),
                np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
                ctypes.c_int64,
                np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS"),
            ]
            lib.irs_copy_runs_u32.restype = None
            lib.irs_copy_runs_u32.argtypes = [
                np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS"),
                np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
                np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
                np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS"),
                ctypes.c_int64,
                np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS"),
            ]
            lib.irs_copy_runs_bytes.restype = None
            lib.irs_copy_runs_bytes.argtypes = [
                np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
                np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
                np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
                np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
                ctypes.c_int64,
                np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
            ]
        except AttributeError:
            lib.irs_merge_decode = None
        # dense-grid cache builder (older .so builds lack it)
        try:
            lib.irs_dense_build.restype = None
            lib.irs_dense_build.argtypes = [
                np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS"),
                ctypes.c_int64,
                ctypes.POINTER(ctypes.c_void_p),
                ctypes.POINTER(ctypes.c_void_p),
                ctypes.POINTER(ctypes.c_void_p),
                np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
                ctypes.c_int64,
                ctypes.c_int64,
                ctypes.c_uint32,
                np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
                ctypes.c_void_p,  # alive u8 or NULL
                ctypes.c_double,
                ctypes.c_double,
                np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS"),
                np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS"),
                np.ctypeslib.ndpointer(np.uint16, flags="C_CONTIGUOUS"),
                np.ctypeslib.ndpointer(np.uint16, flags="C_CONTIGUOUS"),
                np.ctypeslib.ndpointer(np.uint16, flags="C_CONTIGUOUS"),
                np.ctypeslib.ndpointer(np.uint16, flags="C_CONTIGUOUS"),
            ]
        except AttributeError:
            lib.irs_dense_build = None
        _lib = lib
        return _lib


_CASE = {"lower": 0, "none": 1, "upper": 2}
_BREAK = {"alpha": 0, "all": 1, "graphic": 2}


def tokenize_ascii(
    text: str, case: str, word_break: str
) -> Optional[Tuple[bytes, np.ndarray]]:
    """(case-folded bytes, int32 [n,2] start/end offsets), or None when the
    native path is unavailable or the text is not pure ASCII."""
    lib = load()
    if lib is None:
        return None
    try:
        raw = text.encode("ascii")
    except UnicodeEncodeError:
        return None
    buf = ctypes.create_string_buffer(raw, len(raw))
    cap = max(8, len(raw) // 2 + 1)
    out = (ctypes.c_int32 * (2 * cap))()
    n = lib.irs_tokenize_ascii(
        buf, len(raw), _CASE[case], _BREAK[word_break], out, cap
    )
    if n < 0:
        return None
    spans = np.frombuffer(out, dtype=np.int32)[: 2 * n].reshape(n, 2).copy()
    return buf.raw[: len(raw)], spans


def levenshtein_batch(
    cands: np.ndarray,  # u32 [T, L] utf-32 code points, 0-padded
    cand_len: np.ndarray,  # i32 [T]
    query: np.ndarray,  # u32 [Q]
    max_d: int,
    with_transpositions: bool,
) -> Optional[np.ndarray]:
    """Distances i32 [T] (values > max_d reported as max_d+1), or None."""
    lib = load()
    if lib is None:
        return None
    T, L = cands.shape
    out = np.empty(T, np.int32)
    lib.irs_levenshtein_batch(
        np.ascontiguousarray(query, np.uint32),
        len(query),
        np.ascontiguousarray(cands, np.uint32),
        np.ascontiguousarray(cand_len, np.int32),
        T,
        L,
        max_d,
        1 if with_transpositions else 0,
        out,
    )
    return out


def dfa_intersect(
    blob: bytes,
    offsets: np.ndarray,  # i64 [T+1] byte offsets into blob
    lo: int,
    hi: int,
    trans: np.ndarray,  # u16 [S, 256], 0xFFFF = dead
    accept: np.ndarray,  # bool [S]
) -> Optional[np.ndarray]:
    """tids in [lo, hi) whose terms the DFA accepts, or None when the
    native library is unavailable. Incremental-prefix scan with dead-
    subtree binary-search skipping (the automaton x term-index
    intersection, automaton_utils.hpp:91-321)."""
    lib = load()
    if lib is None or getattr(lib, "irs_dfa_intersect", None) is None:
        return None
    cap = max(1, hi - lo)
    out = np.empty(cap, np.int32)
    n = lib.irs_dfa_intersect(
        blob,
        np.ascontiguousarray(offsets, np.int64),
        lo,
        hi,
        np.ascontiguousarray(trans, np.uint16),
        np.ascontiguousarray(accept.astype(np.uint8)),
        out,
        cap,
    )
    return out[:n].copy()


def dfa_determinize(
    n_states: int,
    edge_src: np.ndarray,  # i32 [E]
    edge_lo: np.ndarray,  # u8 [E]
    edge_hi: np.ndarray,  # u8 [E]
    edge_dst: np.ndarray,  # i32 [E]
    eps_src: np.ndarray,  # i32 [P]
    eps_dst: np.ndarray,  # i32 [P]
    accept_mask: np.ndarray,  # u8 [n_states]
    max_states: int,
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Subset construction of a byte NFA (state 0 = start) into dense
    (trans u16 [S, 256], accept bool [S]) tables — the per-query half of
    the reference's automaton pipeline (the reference amortizes it with
    precomputed parametric Levenshtein tables,
    levenshtein_default_pdp.cpp). Returns None when the native library is
    unavailable or the construction exceeds ``max_states`` (caller falls
    back to the Python determinizer / DP)."""
    lib = load()
    if lib is None or getattr(lib, "irs_dfa_determinize", None) is None:
        return None
    out_trans = np.empty((max_states, 256), np.uint16)
    out_accept = np.zeros(max_states, np.uint8)
    n = lib.irs_dfa_determinize(
        n_states,
        len(edge_src),
        np.ascontiguousarray(edge_src, np.int32),
        np.ascontiguousarray(edge_lo, np.uint8),
        np.ascontiguousarray(edge_hi, np.uint8),
        np.ascontiguousarray(edge_dst, np.int32),
        len(eps_src),
        np.ascontiguousarray(eps_src, np.int32),
        np.ascontiguousarray(eps_dst, np.int32),
        np.ascontiguousarray(accept_mask, np.uint8),
        max_states,
        out_trans,
        out_accept,
    )
    if n < 0:
        return None
    return out_trans[:n].copy(), out_accept[:n].astype(np.bool_)


def lev_dfa_build(
    target: str,
    max_d: int,
    with_transpositions: bool,
    prefix: bytes,
    max_states: int,
):
    """One-call (Damerau-)Levenshtein byte-DFA construction: the NFA build
    AND the subset construction both run in C++ (irs_lev_dfa_build),
    collapsing the per-query fuzzy-prepare cost to one ctypes call. Tables
    are bit-identical to search/automaton.py:levenshtein_dfa's Python NFA
    path (pinned by tests/test_automaton.py). Tri-state: (trans, accept)
    on success; False when the construction exceeds ``max_states`` (the
    Python path would too); None when the library is unavailable."""
    lib = load()
    if lib is None or getattr(lib, "irs_lev_dfa_build", None) is None:
        return None
    q = np.array([ord(c) for c in target], np.uint32)
    out_trans = np.empty((max_states, 256), np.uint16)
    out_accept = np.zeros(max_states, np.uint8)
    n = lib.irs_lev_dfa_build(
        q,
        len(q),
        max_d,
        1 if with_transpositions else 0,
        prefix,
        len(prefix),
        max_states,
        out_trans,
        out_accept,
    )
    if n < 0:
        return False
    return out_trans[:n].copy(), out_accept[:n].astype(np.bool_)


def scatter_pack(
    vals: np.ndarray,
    row: np.ndarray,
    lane: np.ndarray,
    cls: np.ndarray,
    rows_per_class,
) -> Optional[tuple]:
    """One-pass classed planar bit-pack (encoder hot loop).

    ``vals[i]`` goes to class ``cls[i]``'s pool at block-row ``row[i]``,
    lane ``lane[i]`` — layout identical to formats/bitpack.pack_blocks.
    Returns the 6 per-class word arrays (row 0 zero sentinel included in
    ``rows_per_class``), or None when the native library is unavailable.
    """
    lib = load()
    if lib is None or getattr(lib, "irs_scatter_pack", None) is None:
        return None
    from iresearch_tpu_torch.formats.bitpack import BITS

    outs = tuple(
        np.zeros((int(rows_per_class[c]), 4 * BITS[c]), np.uint32)
        for c in range(len(BITS))
    )
    ptrs = (ctypes.c_void_p * len(outs))(
        *(o.ctypes.data for o in outs)
    )
    lib.irs_scatter_pack(
        np.ascontiguousarray(vals, np.uint32),
        np.ascontiguousarray(row, np.int64),
        np.ascontiguousarray(lane, np.uint8),
        np.ascontiguousarray(cls, np.uint8),
        len(vals),
        ptrs,
    )
    return outs


def _pool_ptrs(pools) -> "ctypes.Array":
    """(c_void_p * 6) pointer table over per-class pool arrays."""
    return (ctypes.c_void_p * len(pools))(*(p.ctypes.data for p in pools))


def dense_build(
    entries: np.ndarray,  # u32 [T, ncols]
    doc_words,  # 6 per-class u32 pools
    base,  # 6 per-class u32 base arrays
    freq_words,  # 6 per-class u32 pools
    tids: np.ndarray,  # i32 selected term ids of ONE width class
    ndrows: int,
    cls: int,  # grid width class (BITS index)
    dl: np.ndarray,  # f32 [ndrows*128] clamped doc lengths
    alive,  # u8 [num_docs] contiguous, or None
    c0: float,
    c1: float,  # champion-lane BM25 constants
) -> Optional[tuple]:
    """One-pass dense-grid build for one class (build_dense_cache hot
    path): returns (packed u32 [rows_c, wpb], bmaxf u32, dl_min u16,
    f_c u16, dl_c u16, f_mdl u16) with rows_c = 1 + len(tids)*ndrows,
    or None when the native library lacks irs_dense_build. Output is
    element-identical to the numpy builder (tests/test_dense_native.py).
    """
    lib = load()
    if lib is None or getattr(lib, "irs_dense_build", None) is None:
        return None
    from iresearch_tpu_torch.formats.bitpack import BITS, words_per_block

    nt = len(tids)
    rows_c = 1 + nt * ndrows
    packed = np.zeros((rows_c, words_per_block(BITS[cls])), np.uint32)
    bmaxf = np.zeros(rows_c, np.uint32)
    dl_min = np.zeros(rows_c, np.uint16)
    f_c = np.zeros(rows_c, np.uint16)
    dl_c = np.ones(rows_c, np.uint16)
    f_mdl = np.zeros(rows_c, np.uint16)
    lib.irs_dense_build(
        np.ascontiguousarray(entries, np.uint32),
        entries.shape[1],
        _pool_ptrs(doc_words),
        _pool_ptrs(base),
        _pool_ptrs(freq_words),
        np.ascontiguousarray(tids, np.int32),
        nt,
        ndrows,
        cls,
        np.ascontiguousarray(dl, np.float32),
        None if alive is None else alive.ctypes.data,
        float(c0),
        float(c1),
        packed,
        bmaxf,
        dl_min,
        f_c,
        dl_c,
        f_mdl,
    )
    return packed, bmaxf, dl_min, f_c, dl_c, f_mdl


def merge_decode(
    entries: np.ndarray,  # u32 [T, ncols]
    doc_words,  # 6 per-class u32 pools
    base,  # 6 per-class u32 base arrays
    freq_words,  # 6 per-class u32 pools
    dmap: np.ndarray,  # i64 [num_docs] new doc or -1
    tid_remap: np.ndarray,  # i64 [T] merged term ids
    e_cap: int,  # sum(df) upper bound for the outputs
) -> Optional[tuple]:
    """One-pass decode+remap of a segment field (merge hot path).

    Returns (tid i32, doc u32, freq u32, orig_tid i32, pos_off i64) for
    the kept entries — pos_off is the global flat position rank (cumsum
    of freq over ALL entries) indexing positions_flat()/OFFS/PAY — or
    None when the native library is unavailable."""
    lib = load()
    if lib is None or getattr(lib, "irs_merge_decode", None) is None:
        return None
    T = entries.shape[0]
    cap = max(1, e_cap)
    out_tid = np.empty(cap, np.int32)
    out_doc = np.empty(cap, np.uint32)
    out_freq = np.empty(cap, np.uint32)
    out_orig = np.empty(cap, np.int32)
    out_posoff = np.empty(cap, np.int64)
    n = lib.irs_merge_decode(
        np.ascontiguousarray(entries, np.uint32),
        T,
        entries.shape[1],
        _pool_ptrs(doc_words),
        _pool_ptrs(base),
        _pool_ptrs(freq_words),
        np.ascontiguousarray(dmap, np.int64),
        np.ascontiguousarray(tid_remap, np.int64),
        out_tid,
        out_doc,
        out_freq,
        out_orig,
        out_posoff,
    )
    return (
        out_tid[:n],
        out_doc[:n],
        out_freq[:n],
        out_orig[:n],
        out_posoff[:n],
    )


def merge_gather_pos(
    entries: np.ndarray,  # u32 [T, ncols] (PCLS/PSTART columns)
    pos_words,  # 6 per-class u32 position pools
    tid_pos_base: np.ndarray,  # i64 [T] flat base rank per term
    orig_tid: np.ndarray,  # i32 [E]
    src_off: np.ndarray,  # i64 [E] global flat source rank
    freq: np.ndarray,  # u32 [E]
    dst_off: np.ndarray,  # i64 [E] merged flat offsets
    out_pos: np.ndarray,  # u32 [P] output buffer
) -> bool:
    lib = load()
    if lib is None or getattr(lib, "irs_merge_decode", None) is None:
        return False
    lib.irs_merge_gather_pos(
        np.ascontiguousarray(entries, np.uint32),
        entries.shape[1],
        _pool_ptrs(pos_words),
        np.ascontiguousarray(tid_pos_base, np.int64),
        np.ascontiguousarray(orig_tid, np.int32),
        np.ascontiguousarray(src_off, np.int64),
        np.ascontiguousarray(freq, np.uint32),
        np.ascontiguousarray(dst_off, np.int64),
        len(orig_tid),
        out_pos,
    )
    return True


def copy_runs_u32(
    src: np.ndarray, src_off: np.ndarray, dst_off: np.ndarray,
    lens: np.ndarray, out: np.ndarray,
) -> bool:
    lib = load()
    if lib is None or getattr(lib, "irs_merge_decode", None) is None:
        return False
    lib.irs_copy_runs_u32(
        np.ascontiguousarray(src, np.uint32),
        np.ascontiguousarray(src_off, np.int64),
        np.ascontiguousarray(dst_off, np.int64),
        np.ascontiguousarray(lens, np.uint32),
        len(src_off),
        out,
    )
    return True


def copy_runs_bytes(
    src: np.ndarray, src_off: np.ndarray, dst_off: np.ndarray,
    lens: np.ndarray, out: np.ndarray,
) -> bool:
    lib = load()
    if lib is None or getattr(lib, "irs_merge_decode", None) is None:
        return False
    lib.irs_copy_runs_bytes(
        np.ascontiguousarray(src, np.uint8),
        np.ascontiguousarray(src_off, np.int64),
        np.ascontiguousarray(dst_off, np.int64),
        np.ascontiguousarray(lens, np.int64),
        len(src_off),
        out,
    )
    return True


def crc32c(data: bytes, seed: int = 0) -> Optional[int]:
    lib = load()
    if lib is None:
        return None
    return int(lib.irs_crc32c(data, len(data), seed))


class TermDict:
    """Term bytes -> dense id map; native C++ when available.

    The write-path twin of the reference's in-RAM postings hash
    (core/index/postings.hpp:78-125). ``tokenize_to_tids`` runs the whole
    segmentation+lookup inner loop natively for ASCII text.
    """

    def __init__(self) -> None:
        self._lib = load()
        self._h = self._lib.irs_termdict_new() if self._lib is not None else None
        self._py: dict = {}
        self._scratch = (ctypes.c_int32 * 4096)()

    def __del__(self):
        if getattr(self, "_h", None) is not None and self._lib is not None:
            self._lib.irs_termdict_free(self._h)
            self._h = None

    def __len__(self) -> int:
        if self._h is not None:
            return int(self._lib.irs_termdict_size(self._h))
        return len(self._py)

    def add(self, term: bytes) -> int:
        if self._h is not None:
            return int(self._lib.irs_termdict_add(self._h, term, len(term)))
        tid = self._py.get(term)
        if tid is None:
            tid = len(self._py)
            self._py[term] = tid
        return tid

    def tokenize_to_tids(
        self, text: str, case: str, word_break: str
    ) -> Optional[np.ndarray]:
        """Token term-ids (i32) for arbitrary Unicode text (UTF-8 C++
        tokenizer, table-matched to the Python analyzers), or None ->
        caller falls back to per-token add() (native lib missing,
        malformed input, or case-complex code points)."""
        if self._h is None:
            return None
        fn = getattr(self._lib, "irs_tokenize_to_tids_utf8", None)
        raw = text.encode("utf-8")
        if fn is None:  # old .so: ASCII only
            try:
                text.encode("ascii")
            except UnicodeEncodeError:
                return None
            fn = self._lib.irs_tokenize_to_tids
            buf = ctypes.create_string_buffer(raw, len(raw))
        else:
            buf = raw
        cap = max(8, len(raw) // 2 + 1)
        if cap > len(self._scratch):
            self._scratch = (ctypes.c_int32 * (2 * cap))()
        n = fn(
            self._h, buf, len(raw), _CASE[case], _BREAK[word_break],
            self._scratch, cap,
        )
        if n < 0:
            return None
        return np.frombuffer(self._scratch, dtype=np.int32, count=n).copy()

    def merge_from(self, other: "TermDict") -> np.ndarray:
        """Add every term of ``other`` to this dict; returns the int64
        other_id -> this_id map (ONE native call — the register-time
        remap of a transaction's private term dictionary)."""
        n = len(other)
        out = np.empty(max(1, n), np.int32)
        if (
            self._h is not None
            and other._h is not None
            and getattr(self._lib, "irs_termdict_merge", None) is not None
        ):
            self._lib.irs_termdict_merge(self._h, other._h, out)
            return out[:n].astype(np.int64)
        terms = other.terms()
        return np.fromiter(
            (self.add(t) for t in terms), np.int64, count=len(terms)
        )

    def terms(self) -> list:
        """All terms in id order."""
        if self._h is not None:
            size = int(self._lib.irs_termdict_size(self._h))
            nbytes = int(self._lib.irs_termdict_bytes(self._h))
            blob = ctypes.create_string_buffer(max(1, nbytes))
            offsets = np.empty(size + 1, np.int64)
            self._lib.irs_termdict_dump(self._h, blob, offsets)
            raw = blob.raw[:nbytes]
            return [raw[offsets[i] : offsets[i + 1]] for i in range(size)]
        out = [b""] * len(self._py)
        for t, i in self._py.items():
            out[i] = t
        return out
