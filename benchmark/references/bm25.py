"""Plain BM25 top-k over the corpus arrays: the reference of every cell
whose configuration names ``"reference": "bm25"``.

It reads only the benchmark's own corpus (``benchmark/corpus.py``): a
term's postings are the positions where the token array holds it, mapped
to docs by the docs' first tokens. Statistics are index-wide, as the
configuration states: ``N`` docs, a term's ``df`` over every segment, and
``avgdl`` the index's tokens over ``N``. A term's score in a doc is

    (k1 + 1) * log1p((N - df + 0.5) / (df + 0.5)) * tf / (tf + k1 * (1 - b + b * dl / avgdl))

(IResearch's BM25, ``bm25.hpp``), a conjunction's the sum over its terms
in docs that hold all of them, a disjunction's the sum over the terms a
doc holds. Matches rank by (score desc, global doc asc). Everything is
computed in ``dtype``: float64 for the reference; the control computes
the same in bfloat16. Nothing of the program is imported.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Tuple

import torch

from benchmark.corpus import Corpus
from benchmark.traffic import Query


class Answer(NamedTuple):
    docs: torch.Tensor  # int64 [n]: every matching global doc, ascending
    scores: torch.Tensor  # [n] in the reference's dtype
    order: torch.Tensor  # int64 [n]: ``docs`` by (score desc, doc asc)

    @property
    def n(self) -> int:
        return len(self.docs)

    def top(self, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """(docs, scores) of the first ``k`` matches in rank order."""
        o = self.order[:k]
        return self.docs[o], self.scores[o]


class BM25Reference:
    def __init__(self, corpus: Corpus, k1: float, b: float, dtype=torch.float64):
        self.corpus = corpus
        self.k1, self.b, self.dtype = float(k1), float(b), dtype
        self.num_docs = corpus.num_docs
        self.avgdl = corpus.num_tokens / self.num_docs
        self._postings: Dict[int, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = {}

    def postings(self, term: int):
        """(global docs int64 ascending, tf int64, dl int64) of ``term``."""
        got = self._postings.get(term)
        if got is None:
            docs, tfs, dls = [], [], []
            for seg, base in zip(self.corpus.segments, self.corpus.bases):
                pos = torch.nonzero(seg.tids == term).reshape(-1)
                if not len(pos):
                    continue
                doc = torch.searchsorted(seg.starts, pos, right=True) - 1
                d, tf = torch.unique_consecutive(doc, return_counts=True)
                docs.append(d + base)
                tfs.append(tf)
                dls.append(seg.lens[d])
            dev = self.corpus.segments[0].tids.device
            if docs:
                got = (torch.cat(docs), torch.cat(tfs), torch.cat(dls))
            else:
                empty = torch.zeros(0, dtype=torch.int64, device=dev)
                got = (empty, empty, empty)
            self._postings[term] = got
        return got

    def term_scores(self, term: int):
        """(docs, scores) of one term over the index."""
        docs, tf, dl = self.postings(term)
        df = len(docs)
        idf = math.log1p((self.num_docs - df + 0.5) / (df + 0.5))
        dt, dev = self.dtype, docs.device

        def c(x):
            return torch.tensor(x, dtype=dt, device=dev)

        f, n = tf.to(dt), dl.to(dt)
        k1, b = self.k1, self.b
        score = c((k1 + 1.0) * idf) * f / (f + c(k1 * (1.0 - b)) + c(k1 * b / self.avgdl) * n)
        return docs, score

    def evaluate(self, q: Query) -> Answer:
        parts = [self.term_scores(t) for t in q.terms]
        docs, score = parts[0]
        if q.op == "and":
            for d2, s2 in parts[1:]:
                if not len(d2):
                    docs, score = docs[:0], score[:0]
                    continue
                idx = torch.searchsorted(d2, docs).clamp_max_(len(d2) - 1)
                hit = d2[idx] == docs
                docs, score = docs[hit], score[hit] + s2[idx[hit]]
        elif q.op == "or":
            docs = torch.cat([d for d, _s in parts])
            allv = torch.cat([s for _d, s in parts])
            docs, inv = torch.unique(docs, sorted=True, return_inverse=True)
            score = torch.zeros(len(docs), dtype=self.dtype, device=docs.device)
            score.index_add_(0, inv, allv)
        elif q.op != "term":
            raise ValueError(f"op {q.op!r}")
        order = torch.sort(score, descending=True, stable=True).indices
        return Answer(docs, score, order)

    def score_of(self, ans: Answer, docs: torch.Tensor):
        """(found bool [m], scores [m]) of ``docs`` in the answer's matches."""
        if not ans.n:
            return torch.zeros(len(docs), dtype=torch.bool, device=docs.device), None
        idx = torch.searchsorted(ans.docs, docs).clamp_max_(ans.n - 1)
        return ans.docs[idx] == docs, ans.scores[idx]

    def clear(self) -> None:
        self._postings.clear()


def make(corpus: Corpus, config: dict, dtype=torch.float64) -> BM25Reference:
    """The reference of a configuration (its ``scorer`` entry) over its corpus."""
    sc = config["scorer"]
    if sc["kind"] != "bm25":
        raise ValueError(f"scorer {sc['kind']!r}")
    return BM25Reference(corpus, sc["k1"], sc["b"], dtype)
