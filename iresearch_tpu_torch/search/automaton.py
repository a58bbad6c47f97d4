"""Wildcard pattern -> byte DFA for term-dictionary intersection.

Reference: the wildcard/fuzzy filters compile patterns to UTF-8 byte
automata and intersect them with the term index so only reachable
dictionary subtrees are visited (core/utils/wildcard_utils.cpp,
automaton_utils.hpp:91-321, fst_table_matcher.hpp:40). Here:

* ``%`` (any sequence) — over valid UTF-8 any *byte* sequence, so it is
  a plain self-loop;
* ``_`` (exactly one character) — the standard 4-branch UTF-8 byte NFA
  ([00-7F] | [C2-DF][80-BF] | [E0-EF][80-BF]{2} | [F0-F4][80-BF]{3});
* literals match their UTF-8 bytes; ``\\`` escapes.

The NFA is determinized by subset construction into dense ``trans
[S, 256]`` / ``accept [S]`` tables consumed by the native incremental
dictionary scan (native/iresearch_native.cpp:irs_dfa_intersect), which
resumes each term's DFA run from its longest common prefix with the
previous term and binary-searches past dead subtrees — the sorted-array
analog of the reference's automaton x burst-trie intersection
(formats_burst_trie.cpp:3139).
"""

from __future__ import annotations

from typing import Dict, FrozenSet, List, Optional, Tuple

import numpy as np

from .. import native as _native

_MAX_DFA_STATES = 4096


def _nfa_from_wildcard(pattern: bytes):
    """(transitions: list per state of (byte_lo, byte_hi, dst), eps:
    list per state of dst, accept_state). Linear NFA with self-loops
    for %, 4-branch UTF-8 fragments for _."""
    trans: List[List[Tuple[int, int, int]]] = [[]]
    eps: List[List[int]] = [[]]

    def new_state() -> int:
        trans.append([])
        eps.append([])
        return len(trans) - 1

    cur = 0
    i = 0
    n = len(pattern)
    while i < n:
        c = pattern[i : i + 1]
        if c == b"\\" and i + 1 < n:
            lit = pattern[i + 1]
            nxt = new_state()
            trans[cur].append((lit, lit, nxt))
            cur = nxt
            i += 2
            continue
        if c == b"%":
            # self-loop over every byte (any sequence)
            trans[cur].append((0, 255, cur))
            i += 1
            continue
        if c == b"_":
            end = new_state()
            # 1-byte char
            trans[cur].append((0x00, 0x7F, end))
            # 2-byte: [C2-DF][80-BF]
            m1 = new_state()
            trans[cur].append((0xC2, 0xDF, m1))
            trans[m1].append((0x80, 0xBF, end))
            # 3-byte: [E0-EF][80-BF]{2}
            m2 = new_state()
            m3 = new_state()
            trans[cur].append((0xE0, 0xEF, m2))
            trans[m2].append((0x80, 0xBF, m3))
            trans[m3].append((0x80, 0xBF, end))
            # 4-byte: [F0-F4][80-BF]{3}
            m4 = new_state()
            m5 = new_state()
            m6 = new_state()
            trans[cur].append((0xF0, 0xF4, m4))
            trans[m4].append((0x80, 0xBF, m5))
            trans[m5].append((0x80, 0xBF, m6))
            trans[m6].append((0x80, 0xBF, end))
            cur = end
            i += 1
            continue
        lit = pattern[i]
        nxt = new_state()
        trans[cur].append((lit, lit, nxt))
        cur = nxt
        i += 1
    return trans, eps, cur


def wildcard_dfa(pattern: bytes) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """(trans u16 [S, 256] with 0xFFFF = dead, accept bool [S]) for a
    ``%``/``_`` wildcard, start state 0; None if the determinization
    exceeds the state budget (caller falls back to regex)."""
    nfa_trans, eps, acc = _nfa_from_wildcard(pattern)
    gtrans = [[((lo, hi), d) for lo, hi, d in lst] for lst in nfa_trans]
    return _nfa_to_dfa(gtrans, eps, frozenset([acc]))


def _native_determinize(trans, eps, accepts):
    """Flatten the NFA into edge arrays and determinize in C++.

    Tri-state: (trans, accept) on success; False when the construction
    exceeds the state budget (the Python path would too — caller returns
    None); None when the native library is unavailable (caller runs the
    Python subset construction)."""
    from .. import native as _native

    lib = _native.load()
    if lib is None or getattr(lib, "irs_dfa_determinize", None) is None:
        return None
    src: List[int] = []
    lo_: List[int] = []
    hi_: List[int] = []
    dst: List[int] = []
    esrc: List[int] = []
    edst: List[int] = []
    for s, lst in enumerate(trans):
        for (lo, hi), d in lst:
            src.append(s)
            lo_.append(lo)
            hi_.append(hi)
            dst.append(d)
        for d in eps[s]:
            esrc.append(s)
            edst.append(d)
    amask = np.zeros(len(trans), np.uint8)
    for a in accepts:
        amask[a] = 1
    out = _native.dfa_determinize(
        len(trans),
        np.asarray(src, np.int32),
        np.asarray(lo_, np.uint8),
        np.asarray(hi_, np.uint8),
        np.asarray(dst, np.int32),
        np.asarray(esrc, np.int32),
        np.asarray(edst, np.int32),
        amask,
        _MAX_DFA_STATES,
    )
    return out if out is not None else False


def _nfa_to_dfa(
    trans: List[List[Tuple[object, int]]],
    eps: List[List[int]],
    accepts: FrozenSet[int],
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Generic subset construction with ε-closure over a byte NFA.

    ``trans[s]`` holds ((byte_lo, byte_hi), dst) range edges; ``eps[s]``
    ε-destinations; a subset accepts iff its closure meets ``accepts``.
    Returns (trans u16 [S, 256], accept bool [S]) or None past the state
    budget.

    The determinization itself is the per-query hot path of fuzzy/
    wildcard prepare (~6 ms/query in Python at Fuzzy1 sizes), so it runs
    in C++ when the native library is present (irs_dfa_determinize,
    bit-identical tables — pinned by test_automaton); this Python subset
    construction is the fallback."""
    nat = _native_determinize(trans, eps, accepts)
    if nat is not None:
        return nat if nat is not False else None

    def closure(states: FrozenSet[int]) -> FrozenSet[int]:
        seen = set(states)
        stack = list(states)
        while stack:
            s = stack.pop()
            for d in eps[s]:
                if d not in seen:
                    seen.add(d)
                    stack.append(d)
        return frozenset(seen)

    start = closure(frozenset([0]))
    index: Dict[FrozenSet[int], int] = {start: 0}
    order: List[FrozenSet[int]] = [start]
    rows: List[np.ndarray] = []
    qi = 0
    while qi < len(order):
        cur = order[qi]
        qi += 1
        dst_sets: List[set] = [set() for _ in range(256)]
        for s in cur:
            for (lo, hi), d in trans[s]:
                for b in range(lo, hi + 1):
                    dst_sets[b].add(d)
        row = np.full(256, 0xFFFF, np.uint16)
        memo: Dict[FrozenSet[int], int] = {}
        for b in range(256):
            if not dst_sets[b]:
                continue
            raw = frozenset(dst_sets[b])
            j = memo.get(raw)
            if j is None:
                key = closure(raw)
                j = index.get(key)
                if j is None:
                    j = len(order)
                    if j >= _MAX_DFA_STATES:
                        return None
                    index[key] = j
                    order.append(key)
                memo[raw] = j
            row[b] = j
        rows.append(row)
    dfa = np.stack(rows)
    accept = np.asarray(
        [bool(st & accepts) for st in order], np.bool_
    )
    return dfa, accept


# UTF-8 "any one character" byte fragment, shared by `_` and the
# Levenshtein any-char edges
def _native_lev_build(
    target: str, max_d: int, with_transpositions: bool, prefix: bytes
):
    """Indirection over native.lev_dfa_build so tests can force the
    Python NFA path (same tri-state contract)."""
    return _native.lev_dfa_build(
        target, max_d, with_transpositions, prefix, _MAX_DFA_STATES
    )


_UTF8_ANY = (
    ((0x00, 0x7F),),
    ((0xC2, 0xDF), (0x80, 0xBF)),
    ((0xE0, 0xEF), (0x80, 0xBF), (0x80, 0xBF)),
    ((0xF0, 0xF4), (0x80, 0xBF), (0x80, 0xBF), (0x80, 0xBF)),
)


def levenshtein_dfa(
    target: str,
    max_d: int,
    with_transpositions: bool = False,
    prefix: bytes = b"",
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """(Damerau-)Levenshtein byte DFA: accepts exactly the UTF-8 strings
    ``prefix + s`` with edit_distance(s, target) <= max_d.

    The reference intersects a parametric Levenshtein automaton with the
    term index (core/search/levenshtein_filter.cpp:47-52,
    core/utils/levenshtein_utils.cpp); this is the classic (i, e)
    position NFA — match / substitute / insert / delete / (restricted)
    transpose — UTF-8 byte-expanded and determinized, feeding the same
    native sorted-dictionary intersection as wildcard. None when the
    subset construction exceeds the state budget (caller falls back to
    the banded DP).

    When the native library is present the WHOLE construction (NFA build
    + determinization) runs in one C call (irs_lev_dfa_build) — the
    Python NFA assembly below is the fallback and the bit-identical
    oracle (test_automaton.py:test_native_lev_build_equals_python)."""
    nat = _native_lev_build(target, max_d, with_transpositions, prefix)
    if nat is not None:
        return nat if nat is not False else None
    q = [ord(c) for c in target]
    Q = len(q)
    trans: List[List[Tuple[Tuple[int, int], int]]] = []
    eps: List[List[int]] = []

    def new_state() -> int:
        trans.append([])
        eps.append([])
        return len(trans) - 1

    # core grid states first so ids are dense: pos(i, e)
    grid: Dict[Tuple[int, int], int] = {}
    # state 0 must be the NFA start: allocate a start chain for the
    # prefix bytes leading into pos(0, 0)
    start = new_state()
    cur = start
    for b in prefix:
        nxt = new_state()
        trans[cur].append(((b, b), nxt))
        cur = nxt
    for e in range(max_d + 1):
        for i in range(Q + 1):
            grid[(i, e)] = new_state()
    if prefix:
        eps[cur].append(grid[(0, 0)])
    else:
        eps[start].append(grid[(0, 0)])

    def char_edge(src: int, cp: int, dst: int) -> None:
        bs = chr(cp).encode("utf-8")
        c2 = src
        for b in bs[:-1]:
            mid = new_state()
            trans[c2].append(((b, b), mid))
            c2 = mid
        trans[c2].append(((bs[-1], bs[-1]), dst))

    def any_edge(src: int, dst: int) -> None:
        for branch in _UTF8_ANY:
            c2 = src
            for lo, hi in branch[:-1]:
                mid = new_state()
                trans[c2].append(((lo, hi), mid))
                c2 = mid
            lo, hi = branch[-1]
            trans[c2].append(((lo, hi), dst))

    for e in range(max_d + 1):
        for i in range(Q + 1):
            s = grid[(i, e)]
            if i < Q:
                char_edge(s, q[i], grid[(i + 1, e)])  # match
            if e < max_d:
                any_edge(s, grid[(i, e + 1)])  # insertion
                if i < Q:
                    any_edge(s, grid[(i + 1, e + 1)])  # substitution
                    eps[s].append(grid[(i + 1, e + 1)])  # deletion
                if with_transpositions and i + 1 < Q:
                    mid = new_state()
                    char_edge(s, q[i + 1], mid)
                    char_edge(mid, q[i], grid[(i + 2, e + 1)])
    # accept: (i, e) completable by deletions alone — Q - i <= max_d - e
    accepts = frozenset(
        grid[(i, e)]
        for e in range(max_d + 1)
        for i in range(Q + 1)
        if Q - i <= max_d - e
    )
    return _nfa_to_dfa(trans, eps, accepts)


def dfa_matches_python(
    trans: np.ndarray, accept: np.ndarray, terms, lo: int, hi: int
) -> List[int]:
    """Pure-Python fallback intersection over terms[lo:hi] (tests and
    no-native environments)."""
    out = []
    dead = 0xFFFF
    for tid in range(lo, hi):
        st = 0
        for b in terms[tid]:
            st = int(trans[st, b])
            if st == dead:
                break
        else:
            if accept[st]:
                out.append(tid)
    return out
