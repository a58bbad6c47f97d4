"""Host (numpy) query evaluator — the exact-semantics reference engine.

A copy of ``iresearch_tpu/search/host_eval.py``: the oracle the port's
executor is tested against, the prepare step (expansion, stats, host aux
leaves) it plans from, and the evaluator the writer uses for
Remove-by-filter (``match_docs``). Semantics follow the reference:

* boolean algebra: And = conjunction with Not-extraction (exclusion),
  Or = min-match disjunction with Not-extraction
  (boolean_filter.cpp:57-285, boolean_query.cpp:84-244);
* scores: sum-merge of matching children, node boosts multiply downward
  (CompileScore / Sum merger, scorer.hpp:317-460);
* leaves score only the sampled terms (see expand.py), idf aggregated
  index-wide over the sample;
* phrase: tf = number of phrase occurrences; stats = summed idf of parts
  (BM25::collect accumulates += per part, bm25.cpp:366-384);
* All/ByColumnExistence match without frequency -> score 0 under BM25/TFIDF
  (reference: prepare_scorer without a freq attribute, bm25.cpp:414-425).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from iresearch_tpu_torch.formats.postings import decode_positions, decode_term
from iresearch_tpu_torch.formats.spec import TermCols
from iresearch_tpu_torch.index.segment import SegmentReader
from iresearch_tpu_torch.search import filters as F
from iresearch_tpu_torch.search.expand import (
    LeafExpansion,
    expand_leaf,
    expand_phrase_part,
)
from iresearch_tpu_torch.search.scorers import BM25, BoostScore, Scorer, score_block


@dataclass
class HostResult:
    match: np.ndarray  # bool [nd]
    score: np.ndarray  # f32 [nd], zero where not matched


@dataclass
class SparseResult:
    """(matched docs, their scores) — the O(matches) twin of HostResult.

    ``docs`` is sorted unique i64; ``score[i]`` is doc ``docs[i]``'s score.
    Invariant: densifying (scatter) reproduces HostResult exactly up to
    float accumulation order. Used by the planner's aux leaves so a
    ByNested/ngram/column query never allocates [nd] host arrays
    (reference analog: iterators yield only matching docs)."""

    docs: np.ndarray  # i64 [m] sorted unique
    score: np.ndarray  # f32 [m]

    def densify(self, nd: int) -> HostResult:
        match = np.zeros(nd, bool)
        score = np.zeros(nd, np.float32)
        match[self.docs] = True
        score[self.docs] = self.score
        return HostResult(match, score)


def _sparse_empty() -> SparseResult:
    return SparseResult(np.zeros(0, np.int64), np.zeros(0, np.float32))


class _LazyExpansions:
    """id(leaf) -> LeafExpansion, expanded on first access.

    Term lookup + sampling is the dominant host cost of preparing a
    query; when the plan comes from the prepared-plan cache
    (exec/plancache.py) no expansion is ever needed, so it must not be
    paid eagerly. Mapping semantics match the eager dict the planner and
    oracle index into."""

    __slots__ = ("_leaves", "_segments", "_done")

    def __init__(self, segments) -> None:
        self._leaves: Dict[int, F.Filter] = {}
        self._segments = segments
        self._done: Dict[int, LeafExpansion] = {}

    def register(self, flt: F.Filter) -> None:
        self._leaves[id(flt)] = flt

    def __getitem__(self, fid: int) -> LeafExpansion:
        e = self._done.get(fid)
        if e is None:
            e = expand_leaf(self._leaves[fid], self._segments)
            self._done[fid] = e
        return e

    def __contains__(self, fid: int) -> bool:
        return fid in self._leaves


class HostQuery:
    """A prepared (compiled) query over a list of segments."""

    def __init__(
        self,
        flt: F.Filter,
        segments: List[SegmentReader],
        scorer: Optional[Scorer] = None,
    ) -> None:
        self.flt = flt
        self.segments = segments
        self.scorer = scorer or BM25()
        self._expansions = _LazyExpansions(segments)
        self._field_stats: Dict[str, Tuple[int, int]] = {}
        self._collect(flt)
        self._proxy_cache: Dict[Tuple[int, int], np.ndarray] = {}

    # --- prepare: expansion + stats (reference: filter::prepare) --------

    def _field(self, name: str) -> Tuple[int, int]:
        st = self._field_stats.get(name)
        if st is None:
            dwf = 0
            ttf = 0
            for sr in self.segments:
                fp = sr.field(name)
                if fp is not None:
                    dwf += fp.docs_with_field
                    ttf += fp.total_term_freq
            st = (dwf, ttf)
            self._field_stats[name] = st
        return st

    def _collect(self, flt: F.Filter) -> None:
        if isinstance(
            flt,
            (
                F.ByTerm,
                F.ByTerms,
                F.ByPrefix,
                F.ByRange,
                F.ByGranularRange,
                F.ByWildcard,
                F.ByEditDistance,
            ),
        ):
            self._expansions.register(flt)
        elif isinstance(flt, (F.And, F.Or)):
            for c in flt.filters:
                self._collect(c)
        elif isinstance(flt, (F.Not, F.Proxy)):
            self._collect(flt.filter)
        elif isinstance(flt, F.ByNested):
            self._collect(flt.parent)
            self._collect(flt.child)

    # --- execute --------------------------------------------------------

    def execute(self, seg_idx: int) -> HostResult:
        sr = self.segments[seg_idx]
        res = self._eval(self.flt, seg_idx, 1.0)
        alive = sr.alive
        match = res.match & alive
        return HostResult(match, np.where(match, res.score, 0.0).astype(np.float32))

    def top_k(self, k: int) -> List[Tuple[int, float]]:
        """Global top-k as (global_doc, score), ordered by (-score, doc)."""
        out: List[Tuple[int, float]] = []
        base = 0
        for s, sr in enumerate(self.segments):
            r = self.execute(s)
            docs = np.flatnonzero(r.match)
            for d in docs:
                out.append((base + int(d), float(r.score[d])))
            base += sr.num_docs
        out.sort(key=lambda t: (-t[1], t[0]))
        return out[:k]

    # --- node evaluation -----------------------------------------------

    def _eval(self, flt: F.Filter, s: int, boost: float) -> HostResult:
        sr = self.segments[s]
        nd = sr.num_docs

        if isinstance(flt, F.Empty):
            return HostResult(np.zeros(nd, bool), np.zeros(nd, np.float32))
        if isinstance(flt, F.All):
            return HostResult(
                np.ones(nd, bool), np.zeros(nd, np.float32)
            )  # no freq -> score 0 (reference default boost_as_score=false)
        if isinstance(flt, F.ByColumnExistence):
            match = np.zeros(nd, bool)
            if getattr(flt, "prefix_match", False):
                names = [
                    n for n in sr.column_names() if n.startswith(flt.column)
                ]
            else:
                names = [flt.column] if sr.column(flt.column) is not None else []
            for n in names:
                col = sr.column(n)
                if col is not None:
                    match[col.doc_ids().astype(np.int64)] = True
            return HostResult(match, np.zeros(nd, np.float32))
        if isinstance(flt, F.Proxy):
            key = (id(flt), s)
            cached = self._proxy_cache.get(key)
            if cached is None:
                r = self._eval(flt.filter, s, boost * flt.boost)
                self._proxy_cache[key] = r.match
                return r
            r = self._eval(flt.filter, s, boost * flt.boost)
            return HostResult(cached, r.score)
        if isinstance(
            flt,
            (
                F.ByTerm,
                F.ByTerms,
                F.ByPrefix,
                F.ByRange,
                F.ByGranularRange,
                F.ByWildcard,
                F.ByEditDistance,
            ),
        ):
            return self._eval_terms_leaf(flt, s, boost)
        if isinstance(flt, (F.ByPhrase, F.BySamePosition)):
            return self._eval_positional(flt, s, boost)
        if isinstance(flt, F.ByNgramSimilarity):
            return self._eval_ngram_similarity(flt, s, boost)
        if isinstance(flt, F.ByNested):
            return self._eval_nested(flt, s, boost)
        if isinstance(flt, F.And):
            return self._eval_and(flt, s, boost)
        if isinstance(flt, F.Or):
            return self._eval_or(flt, s, boost)
        if isinstance(flt, F.Not):
            # bare Not == All AND NOT x (reference wraps into exclusion)
            inner = self._eval(flt.filter, s, 1.0)
            return HostResult(~inner.match, np.zeros(nd, np.float32))
        raise TypeError(f"unsupported filter: {flt!r}")

    def _eval_terms_leaf(self, flt, s: int, boost: float) -> HostResult:
        sr = self.segments[s]
        nd = sr.num_docs
        field_name = flt.field
        fp = sr.field(field_name)
        match_count = np.zeros(nd, np.int32)
        score = np.zeros(nd, np.float32)
        exp = self._expansions[id(flt)]
        dwf, ttf = self._field(field_name)
        avgdl = (ttf / dwf) if dwf else 1.0
        leaf_boost = boost * flt.boost
        if fp is None:
            return HostResult(np.zeros(nd, bool), score)
        for h in exp.scored:
            if h.seg != s:
                continue
            docs, freqs = decode_term(fp, h.tid)
            idf = self.scorer.idf(exp.stats_df[h.key], dwf)
            w = self.scorer.term_weight(leaf_boost * h.boost, idf)
            dl = np.maximum(fp.norms[docs], 1).astype(np.float32)
            sc = score_block(
                self.scorer,
                np.float32(w),
                freqs.astype(np.float32),
                dl,
                avgdl,
            )
            score[docs] += sc
            match_count[docs] += 1
        for h in exp.unscored:
            if h.seg != s:
                continue
            docs, _ = decode_term(fp, h.tid)
            match_count[docs] += 1
        for tid in exp.unscored_tids.get(s, ()):
            docs, _ = decode_term(fp, int(tid))
            match_count[docs] += 1
        min_match = getattr(flt, "min_match", 1)
        match = match_count >= max(1, min_match)
        return HostResult(match, np.where(match, score, 0.0))

    def _eval_positional(self, flt, s: int, boost: float) -> HostResult:
        nd = self.segments[s].num_docs
        return self._positional_pairs(flt, s, boost).densify(nd)

    def _positional_pairs(self, flt, s: int, boost: float) -> SparseResult:
        """Phrase / same-position as sorted-key set intersection.

        Each part becomes a sorted int64 key array ``doc * cap + (pos -
        offset)``; phrase hits are keys common to every part
        (np.intersect1d), per-doc tf the run length per doc. Fully
        vectorized — the round-1 dict-of-sets version was seconds per
        query at 1M docs (reference: phrase_iterator.hpp:75-160 leapfrogs
        per doc; here the whole corpus intersects at once).
        """
        from iresearch_tpu_torch.formats.postings import term_positions

        sr = self.segments[s]
        if isinstance(flt, F.BySamePosition):
            parts = [(0, fld, [sr.lookup_term(fld, t)]) for fld, t in flt.terms]
            parts = [
                (off, fld, [t for t in tids if t is not None])
                for off, fld, tids in parts
            ]
        else:
            parts = [
                (off, flt.field, expand_phrase_part(p, flt.field, sr))
                for off, p in flt.parts
            ]
        if not parts or any(len(tids) == 0 for _, _, tids in parts):
            return _sparse_empty()
        cap = np.int64(1) << 32  # positions fit u32; doc*cap never collides

        def part_keys(off: int, fld: str, tids) -> Optional[np.ndarray]:
            fp = sr.field(fld)
            if fp is None or not fp.has_positions:
                return None
            arrs = []
            for tid in tids:
                docs, freqs = decode_term(fp, tid)
                flat = term_positions(fp, tid).astype(np.int64)
                doc_of_pos = np.repeat(docs.astype(np.int64), freqs)
                shifted = flat - off
                ok = shifted >= 0
                arrs.append(doc_of_pos[ok] * cap + shifted[ok])
            keys = np.concatenate(arrs) if arrs else np.zeros(0, np.int64)
            # variants of one part may repeat a (doc, pos) slot (synonyms)
            return np.unique(keys)

        key_arrays = []
        for off, fld, tids in parts:
            ka = part_keys(off, fld, tids)
            if ka is None:
                return _sparse_empty()
            key_arrays.append(ka)
        # smallest part drives; intersect in ascending-size order
        order = sorted(range(len(key_arrays)), key=lambda i: len(key_arrays[i]))
        common = key_arrays[order[0]]
        for i in order[1:]:
            if len(common) == 0:
                break
            common = np.intersect1d(common, key_arrays[i], assume_unique=True)
        field_name = parts[0][1]
        fp = sr.field(field_name)
        dwf, ttf = self._field(field_name)
        avgdl = (ttf / dwf) if dwf else 1.0
        # stats: summed idf over parts (reference accumulates += per part)
        idf_sum = 0.0
        for off, fld, tids in parts:
            # per-part df = index-wide df summed over the part's variants
            df = self._phrase_part_df(fld, tids, sr)
            idf_sum += self.scorer.idf(max(df, 1), max(dwf, 1))
        w = self.scorer.term_weight(boost * flt.boost, idf_sum)
        if len(common) == 0:
            return _sparse_empty()
        hit_docs, tf = np.unique(common >> 32, return_counts=True)
        hit_docs = hit_docs.astype(np.int64)
        dl = np.maximum(fp.norms[hit_docs], 1).astype(np.float32)
        sc = score_block(
            self.scorer,
            np.float32(w),
            tf.astype(np.float32).reshape(1, -1),
            dl.reshape(1, -1),
            avgdl,
        ).reshape(-1)
        return SparseResult(hit_docs, sc.astype(np.float32))

    def _eval_ngram_similarity(
        self, flt, s: int, boost: float, sparse: bool = False
    ):
        """Longest ngram-subsequence matching (ngram_similarity_query.cpp).

        A doc matches when the longest subsequence of the query ngrams that
        appears at strictly increasing positions has length >= ceil(Q *
        threshold); score = filter_boost (len/Q) * scorer(tf=count of
        position-disjoint longest sequences). Difference from the
        reference: disjoint repeats may use any longest pattern, not only
        the first-found one. Internally sparse (per-hit-doc dict);
        ``sparse=True`` returns the (docs, scores) pairs directly.
        """
        import math as _math

        sr = self.segments[s]
        nd = sr.num_docs

        def _out(docs: List[int], scs: List[float]):
            pairs = SparseResult(
                np.asarray(docs, np.int64), np.asarray(scs, np.float32)
            )
            return pairs if sparse else pairs.densify(nd)

        fp = sr.field(flt.field)
        if fp is None or not fp.has_positions or not flt.ngrams:
            return _out([], [])
        Q = len(flt.ngrams)
        mm = min(max(int(_math.ceil(Q * flt.threshold)), 1), Q)
        # positions per query index per doc
        doc_pos: Dict[int, List[List[int]]] = {}
        idf_sum = 0.0
        dwf, ttf = self._field(flt.field)
        avgdl = (ttf / dwf) if dwf else 1.0
        for qi, g in enumerate(flt.ngrams):
            df_total = 0
            for sr2 in self.segments:
                fp2 = sr2.field(flt.field)
                tid2 = sr2.lookup_term(flt.field, g)
                if fp2 is not None and tid2 is not None:
                    df_total += int(fp2.entries[tid2, TermCols.DF])
            idf_sum += self.scorer.idf(max(df_total, 1), max(dwf, 1))
            tid = sr.lookup_term(flt.field, g)
            if tid is None:
                continue
            docs, _ = decode_term(fp, tid)
            plists = decode_positions(fp, tid)
            for d, ps in zip(docs, plists):
                slots = doc_pos.setdefault(int(d), [[] for _ in range(Q)])
                slots[qi].extend(int(p) for p in ps)

        def longest_chain(slots, used):
            """(best_len, positions of one best chain).

            Vectorized LIS-flavored DP: the running state is a pos-sorted
            array of (position, best chain length ending there, node id);
            each query ngram's positions batch-query the state with
            searchsorted + prefix-max instead of the O(P^2) dict scan.
            Chains rebuild through per-node backpointers.
            """
            st_pos = np.empty(0, np.int64)
            st_len = np.empty(0, np.int64)
            st_node = np.empty(0, np.int64)
            node_pos: List[np.ndarray] = []
            node_back: List[np.ndarray] = []
            node_base = 0
            best_len, best_node = 0, -1
            used_arr = np.fromiter(used, np.int64, count=len(used))
            for qi in range(len(slots)):
                p = np.asarray(slots[qi], np.int64)
                if len(used_arr):
                    p = p[~np.isin(p, used_arr)]
                if len(p) == 0:
                    continue
                if len(st_pos):
                    cm = np.maximum.accumulate(st_len)
                    am = np.maximum.accumulate(
                        np.where(st_len >= cm, np.arange(len(st_len)), -1)
                    )
                    idx = np.searchsorted(st_pos, p, side="left")
                    has_prev = idx > 0
                    pl = np.where(has_prev, cm[np.maximum(idx - 1, 0)], 0)
                    pb = np.where(
                        has_prev, st_node[am[np.maximum(idx - 1, 0)]], -1
                    )
                else:
                    pl = np.zeros(len(p), np.int64)
                    pb = np.full(len(p), -1, np.int64)
                new_len = pl + 1
                ids = node_base + np.arange(len(p))
                node_pos.append(p)
                node_back.append(pb)
                node_base += len(p)
                mi = int(np.argmax(new_len))
                if int(new_len[mi]) > best_len:
                    best_len, best_node = int(new_len[mi]), int(ids[mi])
                # merge into the sorted state
                allp = np.concatenate([st_pos, p])
                alll = np.concatenate([st_len, new_len])
                alln = np.concatenate([st_node, ids])
                order2 = np.argsort(allp, kind="stable")
                st_pos, st_len, st_node = allp[order2], alll[order2], alln[order2]
            if best_node < 0:
                return 0, []
            npos = np.concatenate(node_pos)
            nback = np.concatenate(node_back)
            chain: List[int] = []
            node = best_node
            while node >= 0:
                chain.append(int(npos[node]))
                node = int(nback[node])
            chain.reverse()
            return best_len, chain

        out_docs: List[int] = []
        out_scs: List[float] = []
        # prefilter: a doc can only reach mm if >= mm distinct ngrams hit it
        for d in sorted(doc_pos):
            slots = doc_pos[d]
            if not sr.alive[d]:
                continue
            if sum(1 for sl in slots if sl) < mm:
                continue
            used: set = set()
            L, chain = longest_chain(slots, used)
            if L < mm:
                continue
            freq = 0
            Lbest = L
            while L == Lbest and chain:
                freq += 1
                used.update(chain)
                L, chain = longest_chain(slots, used)
            fb = Lbest / Q
            w = self.scorer.term_weight(boost * flt.boost, idf_sum)
            dl = np.float32(max(int(fp.norms[d]), 1))
            sc = score_block(
                self.scorer,
                np.float32(w),
                np.float32(freq).reshape(1, 1),
                dl.reshape(1, 1),
                avgdl,
            )[0, 0]
            out_docs.append(int(d))
            out_scs.append(float(fb * sc))
        return _out(out_docs, out_scs)

    def _phrase_part_df(self, field_name: str, tids_in_sr, sr) -> int:
        """Index-wide df of a phrase part (sum of its variants' terms)."""
        terms = {sr.terms(field_name)[tid] for tid in tids_in_sr}
        df = 0
        for sr2 in self.segments:
            fp2 = sr2.field(field_name)
            if fp2 is None:
                continue
            for t in terms:
                tid2 = sr2.lookup_term(field_name, t)
                if tid2 is not None:
                    df += int(fp2.entries[tid2, 0])
        return df

    def _eval_nested(self, flt: F.ByNested, s: int, boost: float) -> HostResult:
        """Parent/child block join, vectorized (reference: nested_filter.cpp).

        Each parent doc p owns the child docs in (prev_parent, p); counts
        come from an exact integer cumsum difference, scores from
        segment-wise np.add.reduceat — no per-parent Python loop.
        """
        sr = self.segments[s]
        nd = sr.num_docs
        parent = self._eval(flt.parent, s, 1.0)
        child = self._eval(flt.child, s, boost * flt.boost)
        match = np.zeros(nd, bool)
        score = np.zeros(nd, np.float32)
        parents = np.flatnonzero(parent.match)
        if len(parents) == 0:
            return HostResult(match, score)
        starts = np.concatenate([[0], parents[:-1] + 1])  # first child slot
        cumm = np.concatenate([[0], np.cumsum(child.match.astype(np.int64))])
        cnt = cumm[parents] - cumm[starts]
        lo = flt.min_match
        hi = flt.max_match if flt.max_match is not None else np.iinfo(np.int64).max
        ok = (cnt >= lo) & (cnt <= hi)
        # per-parent child score sums: reduceat over [start, parent) pairs
        # (empty segments where start == parent get reduceat's quirk value,
        # masked out below)
        bounds = np.empty(2 * len(parents), np.int64)
        bounds[0::2] = starts
        bounds[1::2] = parents
        nonempty = starts < parents
        sums = np.add.reduceat(
            np.where(child.match, child.score, 0.0).astype(np.float64),
            np.minimum(bounds, nd - 1),
        )[0::2]
        sums = np.where(nonempty, sums, 0.0)
        sel = parents[ok]
        match[sel] = True
        score[sel] = sums[ok].astype(np.float32)
        return HostResult(match, score)

    @staticmethod
    def _merge_scores(scores, matches, merge, nd):
        """Combine matching children's scores (ScoreMergeType semantics)."""
        if merge == "noop" or not scores:
            return np.zeros(nd, np.float32)
        if merge == "sum":
            return np.sum(scores, axis=0, dtype=np.float32)
        stack = np.stack(scores)
        mstack = np.stack(matches)
        if merge == "max":
            return np.max(np.where(mstack, stack, -np.inf), axis=0, initial=-np.inf).astype(np.float32)
        # min over matching children only
        out = np.min(np.where(mstack, stack, np.inf), axis=0, initial=np.inf)
        return out.astype(np.float32)

    def _split_not(self, children):
        pos = [c for c in children if not isinstance(c, F.Not)]
        neg = [c.filter for c in children if isinstance(c, F.Not)]
        return pos, neg

    def _eval_and(self, flt: F.And, s: int, boost: float) -> HostResult:
        sr = self.segments[s]
        nd = sr.num_docs
        pos, neg = self._split_not(flt.filters)
        b = boost * flt.boost
        match = np.ones(nd, bool)
        scores = []
        matches = []
        for c in pos:
            r = self._eval(c, s, b)
            match &= r.match
            scores.append(r.score)
            matches.append(r.match)
        score = self._merge_scores(scores, matches, flt.merge, nd)
        for c in neg:
            r = self._eval(c, s, 1.0)
            match &= ~r.match
        score = np.where(np.isfinite(score), score, 0.0).astype(np.float32)
        return HostResult(match, np.where(match, score, 0.0))

    def _eval_or(self, flt: F.Or, s: int, boost: float) -> HostResult:
        sr = self.segments[s]
        nd = sr.num_docs
        pos, neg = self._split_not(flt.filters)
        b = boost * flt.boost
        count = np.zeros(nd, np.int32)
        scores = []
        matches = []
        for c in pos:
            r = self._eval(c, s, b)
            count += r.match.astype(np.int32)
            scores.append(r.score)
            matches.append(r.match)
        score = self._merge_scores(scores, matches, flt.merge, nd)
        score = np.where(np.isfinite(score), score, 0.0).astype(np.float32)
        if flt.min_match <= 0:
            match = np.ones(nd, bool)
        else:
            match = count >= flt.min_match
        for c in neg:
            r = self._eval(c, s, 1.0)
            match &= ~r.match
        return HostResult(match, np.where(match, score, 0.0))

    # --- sparse evaluation (O(matches) host churn) -----------------------
    #
    # Twin of _eval that returns (docs, scores) pairs and never allocates
    # [nd]-sized host arrays on its native paths (reference analog:
    # iterators yield only matching docs, nested_filter.cpp). The dense
    # _eval stays the oracle; test_sparse_eval fuzzes eval_pairs against
    # it. Complement-shaped nodes (Not, All, min_match<=0 Or, Proxy)
    # have inherently O(nd) match sets and fall back to densify+sparsify.

    def eval_pairs(self, flt: F.Filter, s: int, boost: float = 1.0) -> SparseResult:
        if isinstance(flt, F.Empty):
            return _sparse_empty()
        if isinstance(flt, F.ByColumnExistence):
            return self._column_pairs(flt, s)
        if isinstance(
            flt,
            (
                F.ByTerm,
                F.ByTerms,
                F.ByPrefix,
                F.ByRange,
                F.ByGranularRange,
                F.ByWildcard,
                F.ByEditDistance,
            ),
        ):
            return self._terms_pairs(flt, s, boost)
        if isinstance(flt, (F.ByPhrase, F.BySamePosition)):
            return self._positional_pairs(flt, s, boost)
        if isinstance(flt, F.ByNgramSimilarity):
            return self._ngram_pairs(flt, s, boost)
        if isinstance(flt, F.ByNested):
            return self._nested_pairs(flt, s, boost)
        if isinstance(flt, F.And):
            return self._and_pairs(flt, s, boost)
        if isinstance(flt, F.Or) and flt.min_match >= 1:
            return self._or_pairs(flt, s, boost)
        r = self._eval(flt, s, boost)  # fallback: inherently O(nd) nodes
        docs = np.flatnonzero(r.match).astype(np.int64)
        return SparseResult(docs, r.score[docs].astype(np.float32))

    def _column_pairs(self, flt, s: int) -> SparseResult:
        sr = self.segments[s]
        if getattr(flt, "prefix_match", False):
            names = [n for n in sr.column_names() if n.startswith(flt.column)]
        else:
            names = [flt.column] if sr.column(flt.column) is not None else []
        arrs = []
        for n in names:
            col = sr.column(n)
            if col is not None:
                arrs.append(col.doc_ids().astype(np.int64))
        if not arrs:
            return _sparse_empty()
        docs = arrs[0] if len(arrs) == 1 else np.unique(np.concatenate(arrs))
        return SparseResult(docs, np.zeros(len(docs), np.float32))

    def _terms_pairs(self, flt, s: int, boost: float) -> SparseResult:
        sr = self.segments[s]
        fp = sr.field(flt.field)
        if fp is None:
            return _sparse_empty()
        exp = self._expansions[id(flt)]
        dwf, ttf = self._field(flt.field)
        avgdl = (ttf / dwf) if dwf else 1.0
        leaf_boost = boost * flt.boost
        doc_arrs: List[np.ndarray] = []
        sc_arrs: List[np.ndarray] = []
        for h in exp.scored:
            if h.seg != s:
                continue
            docs, freqs = decode_term(fp, h.tid)
            idf = self.scorer.idf(exp.stats_df[h.key], dwf)
            w = self.scorer.term_weight(leaf_boost * h.boost, idf)
            dl = np.maximum(fp.norms[docs], 1).astype(np.float32)
            sc = score_block(
                self.scorer, np.float32(w), freqs.astype(np.float32), dl, avgdl
            )
            doc_arrs.append(docs.astype(np.int64))
            sc_arrs.append(sc.astype(np.float64))
        for h in exp.unscored:
            if h.seg != s:
                continue
            docs, _ = decode_term(fp, h.tid)
            doc_arrs.append(docs.astype(np.int64))
            sc_arrs.append(np.zeros(len(docs), np.float64))
        for tid in exp.unscored_tids.get(s, ()):
            docs, _ = decode_term(fp, int(tid))
            doc_arrs.append(docs.astype(np.int64))
            sc_arrs.append(np.zeros(len(docs), np.float64))
        if not doc_arrs:
            return _sparse_empty()
        all_docs = np.concatenate(doc_arrs)
        ud, inv = np.unique(all_docs, return_inverse=True)
        cnt = np.bincount(inv, minlength=len(ud))
        # f32 accumulation in term order matches the dense score[docs] +=
        ssum = np.zeros(len(ud), np.float32)
        off = 0
        for d, sc in zip(doc_arrs, sc_arrs):
            ssum[inv[off : off + len(d)]] += sc.astype(np.float32)
            off += len(d)
        keep = cnt >= max(1, getattr(flt, "min_match", 1))
        return SparseResult(ud[keep], ssum[keep])

    def _ngram_pairs(self, flt, s: int, boost: float) -> SparseResult:
        r = self._eval_ngram_similarity(flt, s, boost, sparse=True)
        return r

    def _nested_pairs(self, flt: F.ByNested, s: int, boost: float) -> SparseResult:
        """O(matches) block join: counts/sums via searchsorted + reduceat
        over the sparse child pairs (nested_filter.cpp)."""
        parent = self.eval_pairs(flt.parent, s, 1.0)
        child = self.eval_pairs(flt.child, s, boost * flt.boost)
        parents = parent.docs
        if len(parents) == 0:
            return _sparse_empty()
        starts = np.concatenate([[0], parents[:-1] + 1])
        lo_idx = np.searchsorted(child.docs, starts)
        hi_idx = np.searchsorted(child.docs, parents)  # children < parent
        cnt = hi_idx - lo_idx
        lo = flt.min_match
        hi = flt.max_match if flt.max_match is not None else np.iinfo(np.int64).max
        ok = (cnt >= lo) & (cnt <= hi)
        if len(child.docs):
            # same reduceat the dense oracle uses (zeros add exactly); a
            # trailing 0.0 sentinel keeps bound == len(child.docs) a valid
            # reduceat index without clipping the final child off
            bounds = np.empty(2 * len(parents), np.int64)
            bounds[0::2] = lo_idx
            bounds[1::2] = hi_idx
            nonempty = lo_idx < hi_idx
            padded = np.concatenate(
                [child.score.astype(np.float64), [0.0]]
            )
            sums = np.add.reduceat(padded, bounds)[0::2]
            sums = np.where(nonempty, sums, 0.0)
        else:
            sums = np.zeros(len(parents), np.float64)
        return SparseResult(parents[ok], sums[ok].astype(np.float32))

    def _child_scores_at(self, r: SparseResult, docs: np.ndarray) -> np.ndarray:
        """Scores of ``r`` at ``docs`` (docs ⊆ r.docs)."""
        if len(docs) == 0:
            return np.zeros(0, np.float32)
        return r.score[np.searchsorted(r.docs, docs)]

    def _and_pairs(self, flt: F.And, s: int, boost: float) -> SparseResult:
        pos, neg = self._split_not(flt.filters)
        if not pos:  # And of pure exclusions matches ~everything: dense
            r = self._eval(flt, s, boost)
            docs = np.flatnonzero(r.match).astype(np.int64)
            return SparseResult(docs, r.score[docs].astype(np.float32))
        b = boost * flt.boost
        rs = [self.eval_pairs(c, s, b) for c in pos]
        docs = rs[0].docs
        for r in rs[1:]:
            docs = np.intersect1d(docs, r.docs, assume_unique=True)
        for c in neg:
            nr = self.eval_pairs(c, s, 1.0)
            docs = docs[~np.isin(docs, nr.docs, assume_unique=True)]
        if len(docs) == 0:
            return _sparse_empty()
        if flt.merge == "noop":
            return SparseResult(docs, np.zeros(len(docs), np.float32))
        stack = np.stack([self._child_scores_at(r, docs) for r in rs])
        if flt.merge == "sum":
            score = np.sum(stack, axis=0, dtype=np.float32)
        elif flt.merge == "max":
            score = np.max(stack, axis=0).astype(np.float32)
        else:  # min — every child matches every doc in the intersection
            score = np.min(stack, axis=0).astype(np.float32)
        return SparseResult(docs, score)

    def _or_pairs(self, flt: F.Or, s: int, boost: float) -> SparseResult:
        pos, neg = self._split_not(flt.filters)
        b = boost * flt.boost
        rs = [self.eval_pairs(c, s, b) for c in pos]
        if not rs:
            return _sparse_empty()
        all_docs = np.concatenate([r.docs for r in rs])
        if len(all_docs) == 0:
            return _sparse_empty()
        ud, inv = np.unique(all_docs, return_inverse=True)
        cnt = np.bincount(inv, minlength=len(ud))
        if flt.merge == "sum":
            score = np.zeros(len(ud), np.float32)
            off = 0
            for r in rs:  # child-order f32 accumulation (match dense sum)
                score[inv[off : off + len(r.docs)]] += r.score
                off += len(r.docs)
        elif flt.merge == "noop":
            score = np.zeros(len(ud), np.float32)
        else:
            fill = -np.inf if flt.merge == "max" else np.inf
            score = np.full(len(ud), fill, np.float32)
            ufunc = np.maximum if flt.merge == "max" else np.minimum
            off = 0
            for r in rs:
                ufunc.at(score, inv[off : off + len(r.docs)], r.score)
                off += len(r.docs)
            score = np.where(np.isfinite(score), score, 0.0).astype(np.float32)
        keep = cnt >= flt.min_match
        docs, score = ud[keep], score[keep]
        for c in neg:
            nr = self.eval_pairs(c, s, 1.0)
            m = ~np.isin(docs, nr.docs, assume_unique=True)
            docs, score = docs[m], score[m]
        return SparseResult(docs, score)


def match_docs(flt: F.Filter, sr: SegmentReader) -> np.ndarray:
    """Alive docs matching ``flt`` in one segment (writer delete path)."""
    q = HostQuery(flt, [sr], BoostScore())
    return np.flatnonzero(q.execute(0).match)


def search(
    reader, flt: F.Filter, scorer: Optional[Scorer] = None, k: int = 10
) -> List[Tuple[int, float]]:
    """Convenience: top-k (global_doc, score) over a DirectoryReader."""
    q = HostQuery(flt, list(reader.segments), scorer)
    return q.top_k(k)
