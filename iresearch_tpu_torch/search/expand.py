"""Multi-term expansion + sampling, shared by host oracle and TPU planner.

Reference behaviors matched:
* prefix/range/wildcard sample the top ``scored_terms_limit`` (segment, term)
  visits by (per-segment df, visitation order) — evicted terms still MATCH
  but contribute no score (limited_sample_collector.hpp:73-150,
  term_frequency key at :247-258).
* fuzzy keeps the top unique terms by similarity boost
  (top_terms_collector.hpp:123; levenshtein_filter.cpp:47-52:
  boost = 1 - distance/min(|term|,|target|) in codepoints).
* stats (df for idf) aggregate over the scored sample only, per unique term
  (limited_sample_collector score phase).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from iresearch_tpu_torch.formats.spec import TermCols
from iresearch_tpu_torch.index.segment import SegmentReader
from iresearch_tpu_torch.search import filters as F


@dataclass
class TermHit:
    seg: int
    tid: int
    df: int
    boost: float
    key: bytes  # unique-term stats key


@dataclass
class LeafExpansion:
    scored: List[TermHit] = field(default_factory=list)
    unscored: List[TermHit] = field(default_factory=list)
    # vectorized unscored representation for contiguous-range leaves
    # (prefix/range): seg -> sorted tid array, disjoint from `unscored`.
    # A 10k-term prefix band stays ONE numpy array instead of 10k TermHit
    # objects (reference analog: multiterm bit_union visits cookies
    # without materializing per-term state, formats.hpp:228).
    unscored_tids: Dict[int, np.ndarray] = field(default_factory=dict)
    stats_df: Dict[bytes, int] = field(default_factory=dict)

    def finalize_stats(self) -> None:
        self.stats_df = {}
        for h in self.scored:
            self.stats_df[h.key] = self.stats_df.get(h.key, 0) + h.df

    def has_unscored(self, seg: int) -> bool:
        tids = self.unscored_tids.get(seg)
        if tids is not None and len(tids):
            return True
        return any(h.seg == seg for h in self.unscored)

    def max_scored_df(self, seg: int) -> int:
        return max(
            (h.df for h in self.scored if h.seg == seg), default=0
        )


def _df_of(sr: SegmentReader, field_name: str, tid: int) -> int:
    return int(sr.field(field_name).entries[tid, TermCols.DF])


def wildcard_to_regex(pattern: bytes) -> "re.Pattern":
    """``%``/``_``/``\\`` wildcard to a compiled regex over str."""
    pat = pattern.decode("utf-8")
    out = []
    i = 0
    while i < len(pat):
        c = pat[i]
        if c == "\\" and i + 1 < len(pat):
            out.append(re.escape(pat[i + 1]))
            i += 2
            continue
        if c == "%":
            out.append(".*")
        elif c == "_":
            out.append(".")
        else:
            out.append(re.escape(c))
        i += 1
    return re.compile("".join(out), re.DOTALL)


def wildcard_fixed_prefix(pattern: bytes) -> bytes:
    """Literal prefix before the first unescaped wildcard (scan bound)."""
    out = bytearray()
    i = 0
    while i < len(pattern):
        c = pattern[i : i + 1]
        if c == b"\\" and i + 1 < len(pattern):
            out += pattern[i + 1 : i + 2]
            i += 2
            continue
        if c in (b"%", b"_"):
            break
        out += c
        i += 1
    else:
        return bytes(out)
    # trim partial multibyte utf-8 tail (a wildcard may match mid-char)
    while out and (out[-1] & 0xC0) == 0x80:
        out.pop()
    return bytes(out)


def classify_wildcard(pattern: bytes) -> str:
    """'term' | 'match_all' | 'prefix' | 'wildcard'
    (reference: WildcardType, wildcard_utils.hpp:30)."""
    has_wild = False
    i = 0
    n = len(pattern)
    while i < n:
        c = pattern[i : i + 1]
        if c == b"\\":
            i += 2
            continue
        if c == b"_":
            return "wildcard"
        if c == b"%":
            has_wild = True
            # only a match-all/prefix if all remaining are %
            j = i
            while j < n and pattern[j : j + 1] == b"%":
                j += 1
            if j == n:
                return "match_all" if i == 0 else "prefix"
            return "wildcard"
        i += 1
    return "term"


def _unescape(pattern: bytes) -> bytes:
    out = bytearray()
    i = 0
    while i < len(pattern):
        if pattern[i : i + 1] == b"\\" and i + 1 < len(pattern):
            out += pattern[i + 1 : i + 2]
            i += 2
        else:
            out += pattern[i : i + 1]
            i += 1
    return bytes(out)


def levenshtein_distances(
    candidates: Sequence[str],
    query: str,
    with_transpositions: bool,
    max_d: Optional[int] = None,
) -> np.ndarray:
    """Vectorized (Damerau-)Levenshtein distance of query vs candidates.

    Replaces the reference's parametric Levenshtein DFA
    (core/utils/levenshtein_utils.cpp) with a batch DP across the whole
    candidate set. With ``max_d`` given, the native banded C++ kernel is
    used when available (distances > max_d are reported as max_d + 1).
    """
    T = len(candidates)
    if T == 0:
        return np.zeros(0, np.int32)
    L = max(max(len(c) for c in candidates), 1)
    Q = len(query)
    cand = np.full((T, L), -1, np.int32)
    for t, c in enumerate(candidates):
        cand[t, : len(c)] = np.frombuffer(
            c.encode("utf-32-le"), dtype=np.uint32
        ).astype(np.int32)
    q = np.frombuffer(query.encode("utf-32-le"), dtype=np.uint32).astype(np.int32)

    if max_d is not None and Q > 0:
        from iresearch_tpu_torch import native

        lens32 = np.fromiter(
            (len(c) for c in candidates), np.int32, count=T
        )
        got = native.levenshtein_batch(
            np.where(cand < 0, 0, cand).astype(np.uint32),
            lens32,
            q.astype(np.uint32),
            int(max_d),
            with_transpositions,
        )
        if got is not None:
            return got

    BIG = np.int32(10**6)
    prev = np.broadcast_to(np.arange(L + 1, dtype=np.int32), (T, L + 1)).copy()
    prev2 = None
    for i in range(1, Q + 1):
        cur = np.empty_like(prev)
        cur[:, 0] = i
        sub_cost = (cand != q[i - 1]).astype(np.int32)
        for j in range(1, L + 1):
            best = np.minimum(prev[:, j] + 1, prev[:, j - 1] + sub_cost[:, j - 1])
            np.minimum(best, cur[:, j - 1] + 1, out=best)
            if with_transpositions and i > 1 and j > 1:
                tr = np.where(
                    (cand[:, j - 1] == q[i - 2]) & (cand[:, j - 2] == q[i - 1]),
                    prev2[:, j - 2] + 1,
                    BIG,
                )
                np.minimum(best, tr, out=best)
            cur[:, j] = best
        prev2 = prev
        prev = cur
    lens = np.fromiter((len(c) for c in candidates), np.int64, count=T)
    return prev[np.arange(T), lens]


def _sample(
    hits: List[TermHit], limit: int
) -> Tuple[List[TermHit], List[TermHit]]:
    """Top-``limit`` hits by (df, visit order); rest unscored.

    Mirrors limited_sample_collector's heap: higher df wins, ties go to the
    later visit.
    """
    if len(hits) <= limit:
        return hits, []
    from iresearch_tpu_torch.utils.metrics import registry

    registry().counter(
        "irs_scored_terms_truncated",
        len(hits) - limit,
        help_="multiterm expansions past scored_terms_limit "
        "(matched but unscored, limited_sample_collector semantics)",
    )
    order = sorted(
        range(len(hits)), key=lambda i: (hits[i].df, i), reverse=True
    )
    keep = set(order[:limit])
    scored = [h for i, h in enumerate(hits) if i in keep]
    unscored = [h for i, h in enumerate(hits) if i not in keep]
    return scored, unscored


def expand_leaf(flt: F.Filter, segments: List[SegmentReader]) -> LeafExpansion:
    """Expand a leaf filter into per-segment term hits + sampled scoring."""
    exp = LeafExpansion()
    if isinstance(flt, F.ByTerm):
        for s, sr in enumerate(segments):
            if sr.field(flt.field) is None:
                continue
            tid = sr.lookup_term(flt.field, flt.term)
            if tid is not None:
                exp.scored.append(
                    TermHit(s, tid, _df_of(sr, flt.field, tid), 1.0, flt.term)
                )
        exp.finalize_stats()
        return exp

    if isinstance(flt, F.ByTerms):
        for s, sr in enumerate(segments):
            if sr.field(flt.field) is None:
                continue
            for term, boost in flt.terms:
                tid = sr.lookup_term(flt.field, term)
                if tid is not None:
                    exp.scored.append(
                        TermHit(s, tid, _df_of(sr, flt.field, tid), boost, term)
                    )
        exp.finalize_stats()
        return exp

    if isinstance(flt, (F.ByPrefix, F.ByRange, F.ByWildcard, F.ByGranularRange)):
        ranges = [
            _matching_ranges(flt, sr) if sr.field(flt.field) is not None else []
            for sr in segments
        ]
        if all(r is not None for r in ranges):
            return _expand_ranges(flt, segments, ranges)
        # general wildcard, multi-segment: one byte-DFA intersect against
        # the merged dictionary instead of S per-segment scans (VERDICT
        # r4 item 2); visit order is term-major (sampling tie-breaks are
        # policy, and prepare stays shared so device/oracle agree)
        if isinstance(flt, F.ByWildcard) and len(segments) > 1:
            from iresearch_tpu_torch.index.multidict import merged_dict
            from iresearch_tpu_torch.search.automaton import wildcard_dfa

            dfa = wildcard_dfa(flt.pattern)
            md = merged_dict(segments, flt.field) if dfa is not None else None
            if md is not None:
                prefix = wildcard_fixed_prefix(flt.pattern)
                lo, hi = (
                    md.prefix_range(prefix) if prefix else (0, md.num_terms)
                )
                mids = md.dfa_intersect(lo, hi, dfa[0], dfa[1])
                if mids is not None:
                    hits = []
                    for m in mids:
                        mid = int(m)
                        term = md.term(mid)
                        for s, sr in enumerate(segments):
                            tid = int(md.seg_tid[s, mid])
                            if tid >= 0:
                                hits.append(
                                    TermHit(
                                        s, tid,
                                        _df_of(sr, flt.field, tid),
                                        1.0, term,
                                    )
                                )
                    exp.scored, exp.unscored = _sample(
                        hits, flt.scored_terms_limit
                    )
                    exp.finalize_stats()
                    return exp
        # non-range wildcard: regex scan (see automaton note in
        # _iterate_matching)
        hits: List[TermHit] = []
        for s, sr in enumerate(segments):
            fp = sr.field(getattr(flt, "field"))
            if fp is None:
                continue
            for tid, term in _iterate_matching(flt, sr):
                hits.append(
                    TermHit(s, tid, _df_of(sr, flt.field, tid), 1.0, term)
                )
        exp.scored, exp.unscored = _sample(hits, flt.scored_terms_limit)
        exp.finalize_stats()
        return exp

    if isinstance(flt, F.ByEditDistance):
        target = flt.term.decode("utf-8", "replace")
        by_term: Dict[bytes, List[TermHit]] = {}
        boosts: Dict[bytes, float] = {}
        full_prefix = flt.prefix
        # Levenshtein byte-DFA (search/automaton.py:levenshtein_dfa): the
        # native sorted-dictionary intersection visits only reachable
        # subtrees — sublinear in |dict| — instead of running the banded
        # DP over the whole length-filtered candidate band (reference:
        # levenshtein_filter.cpp:47-52 intersects a parametric DFA with
        # the term index). d > 2 keeps the DP (DFA state blowup).
        lev_dfa = None
        if flt.max_distance <= 2:
            from iresearch_tpu_torch.search.automaton import levenshtein_dfa

            lev_dfa = levenshtein_dfa(
                target, flt.max_distance, flt.with_transpositions,
                prefix=full_prefix,
            )
        # multi-segment: ONE DFA intersect + ONE distance pass against
        # the merged dictionary replaces S per-segment intersections
        # (VERDICT r4 item 2; reference analog: one automaton intersect
        # with cached multiterm state, multiterm_query.hpp)
        mids = md = None
        if lev_dfa is not None and len(segments) > 1:
            from iresearch_tpu_torch.index.multidict import merged_dict

            md = merged_dict(segments, flt.field)
            if md is not None:
                lo, hi = (
                    md.prefix_range(full_prefix)
                    if full_prefix
                    else (0, md.num_terms)
                )
                mids = md.dfa_intersect(lo, hi, lev_dfa[0], lev_dfa[1])
        if mids is not None:
            terms_sel = [md.term(int(m)) for m in mids]
            cands_sel = [
                t[len(full_prefix):].decode("utf-8", "replace")
                for t in terms_sel
            ]
            if terms_sel:
                dists = levenshtein_distances(
                    cands_sel, target, flt.with_transpositions,
                    max_d=flt.max_distance,
                )
                for k in np.flatnonzero(dists <= flt.max_distance):
                    idx = int(k)
                    term = terms_sel[idx]
                    d = int(dists[idx])
                    size = min(len(cands_sel[idx]), len(target)) or 1
                    boost = 1.0 - d / size if d else 1.0
                    mid = int(mids[idx])
                    hl = by_term.setdefault(term, [])
                    for s, sr in enumerate(segments):
                        tid = int(md.seg_tid[s, mid])
                        if tid >= 0:
                            hl.append(
                                TermHit(
                                    s, tid,
                                    _df_of(sr, flt.field, tid),
                                    boost, term,
                                )
                            )
                    boosts[term] = max(boosts.get(term, 0.0), boost)
            segments_iter = []  # merged path covered every segment
        else:
            segments_iter = list(enumerate(segments))
        for s, sr in segments_iter:
            fp = sr.field(flt.field)
            if fp is None:
                continue
            all_terms = sr.terms(flt.field)
            lo, hi = (
                sr.term_prefix_range(flt.field, full_prefix)
                if full_prefix
                else (0, len(all_terms))
            )
            tids = None
            if lev_dfa is not None:
                from iresearch_tpu_torch import native

                tids = native.dfa_intersect(
                    fp.term_blob,
                    fp.term_offsets.astype(np.int64),
                    lo,
                    hi,
                    lev_dfa[0],
                    lev_dfa[1],
                )
            if tids is not None:
                # survivors only: exact distances (for the similarity
                # boost) over the tiny DFA-matched set
                tid_list = [int(t) for t in tids]
                terms_sel = [all_terms[t] for t in tid_list]
                cands_sel = [
                    t[len(full_prefix):].decode("utf-8", "replace")
                    for t in terms_sel
                ]
            else:
                if hi > lo:
                    from iresearch_tpu_torch.utils.metrics import registry

                    registry().counter(
                        "irs_fuzzy_band_fallback",
                        hi - lo,
                        help_="fuzzy candidates scanned by the banded DP "
                        "because the Levenshtein DFA path was unavailable "
                        "(d > 2, state budget, or no native lib)",
                    )
                terms = all_terms[lo:hi]
                # suffix after the fixed prefix carries the distance
                cands = [
                    t[len(full_prefix):].decode("utf-8", "replace")
                    for t in terms
                ]
                lens = np.fromiter(
                    (len(c) for c in cands), np.int64, count=len(cands)
                )
                pre = np.flatnonzero(
                    np.abs(lens - len(target)) <= flt.max_distance
                )
                if len(pre) == 0:
                    continue
                tid_list = [lo + int(i) for i in pre]
                terms_sel = [terms[int(i)] for i in pre]
                cands_sel = [cands[int(i)] for i in pre]
            if not tid_list:
                continue
            dists = levenshtein_distances(
                cands_sel,
                target,
                flt.with_transpositions,
                max_d=flt.max_distance,
            )
            ok = np.flatnonzero(dists <= flt.max_distance)
            for k in ok:
                idx = int(k)
                term = terms_sel[idx]
                d = int(dists[idx])
                size = min(len(cands_sel[idx]), len(target)) or 1
                boost = 1.0 - d / size if d else 1.0
                tid = tid_list[idx]
                hit = TermHit(
                    s, tid, _df_of(sr, flt.field, tid), boost, term
                )
                by_term.setdefault(term, []).append(hit)
                boosts[term] = max(boosts.get(term, 0.0), boost)
        # top unique terms by similarity boost (top_terms_collector)
        terms_sorted = sorted(
            by_term, key=lambda t: (boosts[t], t), reverse=True
        )
        scored_terms = set(terms_sorted[: flt.scored_terms_limit])
        for term, hl in by_term.items():
            if term in scored_terms:
                exp.scored.extend(hl)
            else:
                exp.unscored.extend(hl)
        exp.finalize_stats()
        return exp

    raise TypeError(f"not an expandable leaf: {flt!r}")


def _matching_ranges(flt, sr: SegmentReader):
    """[(lo, hi), ...] tid ranges for a contiguous-range leaf, or None
    when the leaf is not range-representable (general wildcard)."""
    if isinstance(flt, F.ByPrefix):
        return [sr.term_prefix_range(flt.field, flt.prefix)]
    if isinstance(flt, F.ByRange):
        return [
            sr.term_range(
                flt.field, flt.low, flt.high, flt.include_low, flt.include_high
            )
        ]
    if isinstance(flt, F.ByGranularRange):
        from iresearch_tpu_torch.analysis.numeric import granular_term_ranges

        return [
            sr.term_range(flt.field, tlo, thi, True, True)
            for tlo, thi in granular_term_ranges(
                flt.low, flt.high, flt.include_low, flt.include_high
            )
        ]
    if isinstance(flt, F.ByWildcard):
        kind = classify_wildcard(flt.pattern)
        if kind == "term":
            tid = sr.lookup_term(flt.field, _unescape(flt.pattern))
            return [] if tid is None else [(tid, tid + 1)]
        if kind == "match_all":
            return [(0, len(sr.terms(flt.field)))]
        if kind == "prefix":
            return [
                sr.term_prefix_range(
                    flt.field, wildcard_fixed_prefix(flt.pattern)
                )
            ]
        return None
    return None


def _expand_ranges(
    flt, segments: List[SegmentReader], ranges: List[List[Tuple[int, int]]]
) -> LeafExpansion:
    """Vectorized expansion of contiguous tid ranges.

    Semantics identical to the TermHit-per-term path (same visit order,
    same (df, visit-order) sampling — limited_sample_collector.hpp:73),
    but a 10k-term band costs numpy array ops instead of 10k Python
    objects; unscored terms stay as per-segment tid ARRAYS
    (LeafExpansion.unscored_tids) for the planner to emit vectorized.
    """
    exp = LeafExpansion()
    limit = flt.scored_terms_limit
    seg_tids: List[np.ndarray] = []
    seg_dfs: List[np.ndarray] = []
    seg_ids: List[int] = []
    for s, rs in enumerate(ranges):
        if not rs:
            continue
        fp = segments[s].field(flt.field)
        parts = [np.arange(lo, hi, dtype=np.int64) for lo, hi in rs if hi > lo]
        if not parts:
            continue
        tids = parts[0] if len(parts) == 1 else np.concatenate(parts)
        seg_tids.append(tids)
        seg_dfs.append(fp.entries[tids, TermCols.DF].astype(np.int64))
        seg_ids.append(s)
    if not seg_tids:
        return exp
    counts = [len(t) for t in seg_tids]
    tid_g = np.concatenate(seg_tids)
    df_g = np.concatenate(seg_dfs)
    seg_g = np.repeat(np.asarray(seg_ids, np.int64), counts)
    ntot = len(tid_g)
    if ntot <= limit:
        keep = np.arange(ntot)
    else:
        from iresearch_tpu_torch.utils.metrics import registry

        registry().counter(
            "irs_scored_terms_truncated",
            ntot - limit,
            help_="multiterm expansions past scored_terms_limit "
            "(matched but unscored, limited_sample_collector semantics)",
        )
        # top-``limit`` by (df, visit order), ties to the later visit —
        # exactly the _sample() heap order
        idx = np.arange(ntot)
        keep = np.sort(np.lexsort((idx, df_g))[-limit:])
    keep_mask = np.zeros(ntot, np.bool_)
    keep_mask[keep] = True
    for i in keep:
        s = int(seg_g[i])
        tid = int(tid_g[i])
        term = segments[s].terms(flt.field)[tid]
        exp.scored.append(TermHit(s, tid, int(df_g[i]), 1.0, term))
    base = 0
    for s, n in zip(seg_ids, counts):
        um = ~keep_mask[base : base + n]
        if um.any():
            exp.unscored_tids[s] = tid_g[base : base + n][um]
        base += n
    exp.finalize_stats()
    return exp


def _iterate_matching(flt, sr: SegmentReader):
    """Yield (tid, term) for dictionary terms matching a range-ish leaf."""
    if isinstance(flt, F.ByPrefix):
        lo, hi = sr.term_prefix_range(flt.field, flt.prefix)
        terms = sr.terms(flt.field)
        for tid in range(lo, hi):
            yield tid, terms[tid]
        return
    if isinstance(flt, F.ByRange):
        lo, hi = sr.term_range(
            flt.field, flt.low, flt.high, flt.include_low, flt.include_high
        )
        terms = sr.terms(flt.field)
        for tid in range(lo, hi):
            yield tid, terms[tid]
        return
    if isinstance(flt, F.ByGranularRange):
        from iresearch_tpu_torch.analysis.numeric import granular_term_ranges

        terms = sr.terms(flt.field)
        for tlo, thi in granular_term_ranges(
            flt.low, flt.high, flt.include_low, flt.include_high
        ):
            lo, hi = sr.term_range(flt.field, tlo, thi, True, True)
            for tid in range(lo, hi):
                yield tid, terms[tid]
        return
    if isinstance(flt, F.ByWildcard):
        kind = classify_wildcard(flt.pattern)
        terms = sr.terms(flt.field)
        if kind == "term":
            term = _unescape(flt.pattern)
            tid = sr.lookup_term(flt.field, term)
            if tid is not None:
                yield tid, term
            return
        if kind == "match_all":
            for tid, t in enumerate(terms):
                yield tid, t
            return
        if kind == "prefix":
            lo, hi = sr.term_prefix_range(
                flt.field, wildcard_fixed_prefix(flt.pattern)
            )
            for tid in range(lo, hi):
                yield tid, terms[tid]
            return
        prefix = wildcard_fixed_prefix(flt.pattern)
        lo, hi = (
            sr.term_prefix_range(flt.field, prefix) if prefix else (0, len(terms))
        )
        # byte-DFA x sorted-dictionary intersection (the automaton path,
        # automaton_utils.hpp:91-321): dead subtrees are skipped by
        # binary search instead of regex-matching every term in range
        from iresearch_tpu_torch.search.automaton import wildcard_dfa

        dfa = wildcard_dfa(flt.pattern)
        if dfa is not None:
            from iresearch_tpu_torch import native

            fp = sr.field(flt.field)
            tids = native.dfa_intersect(
                fp.term_blob,
                fp.term_offsets.astype(np.int64),
                lo,
                hi,
                dfa[0],
                dfa[1],
            )
            if tids is not None:
                for tid in tids:
                    yield int(tid), terms[int(tid)]
                return
        from iresearch_tpu_torch.utils.metrics import registry

        registry().counter(
            "irs_wildcard_regex_fallback",
            hi - lo,
            help_="terms matched by per-term regex because the DFA path "
            "was unavailable (no native lib or state-budget blowup)",
        )
        rx = wildcard_to_regex(flt.pattern)
        for tid in range(lo, hi):
            if rx.fullmatch(terms[tid].decode("utf-8", "replace")) is not None:
                yield tid, terms[tid]
        return
    raise TypeError(flt)


def expand_phrase_part(
    part: F.PhrasePart, field_name: str, sr: SegmentReader
) -> List[int]:
    """tids matching one variadic phrase position in one segment."""
    if isinstance(part, F.PhraseTerm):
        tid = sr.lookup_term(field_name, part.term)
        return [] if tid is None else [tid]
    if isinstance(part, F.PhraseSet):
        out = []
        for t in part.terms:
            tid = sr.lookup_term(field_name, t)
            if tid is not None:
                out.append(tid)
        return out
    if isinstance(part, F.PhrasePrefix):
        lo, hi = sr.term_prefix_range(field_name, part.prefix)
        return list(range(lo, hi))
    if isinstance(part, F.PhraseWildcard):
        dummy = F.ByWildcard(field_name, part.pattern)
        return [tid for tid, _ in _iterate_matching(dummy, sr)]
    if isinstance(part, F.PhraseFuzzy):
        dummy = F.ByEditDistance(
            field_name,
            part.term,
            max_distance=part.max_distance,
            with_transpositions=part.with_transpositions,
        )
        exp = expand_leaf(dummy, [sr])
        return sorted({h.tid for h in exp.scored + exp.unscored})
    raise TypeError(part)
