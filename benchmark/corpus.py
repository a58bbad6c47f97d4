"""The corpus law, drawn on the device from ``--seed``.

A configuration's ``corpus`` entry gives the law: ``vocab`` terms whose
token counts follow Zipf(``zipf_s``) over ranks 1..``vocab``, and doc
lengths spread evenly over ``doc_len = [lo, hi)`` tokens (``PERF.md`` §4
gives where each number comes from). Each segment of ``n`` docs holds the
same multiset for every seed: its doc lengths are ``lo + (i mod (hi - lo))``
for ``i < n``, and its ``T`` tokens hold term rank ``r`` ``round(T * p_r)``
times (largest remainders, so they sum to ``T``). The seed draws the rest:
which doc has which length, where each token lies (a uniform shuffle of
the segment's tokens, so which docs hold a term and at what positions),
and which term id each rank gets. So two seeds give different corpora
that hold the same work: a term of a given rank has the same number of
tokens on every seed, and its doc count moves only by the docs that hold
it twice. Where the seed drew each token on its own, a term's doc count
moved by about its square root, the terms at the program's row buckets'
edges landed on either side of them, and the same 400 queries made 16 to
22 signature groups by seed (``PERF.md`` §6).

Term ranks come from the corpus's own doc counts (``doc_freqs``), computed
here from the token arrays and not from any reader of the program.
"""

from __future__ import annotations

import hashlib
from typing import List, NamedTuple, Sequence

import numpy as np
import torch

DOC_CHUNK = 1 << 20  # docs per pass of ``doc_freqs``


def stream_seed(seed: int, stream: str) -> int:
    """A 63-bit generator seed for one named stream of ``seed`` (any
    whole number, negative or past 64 bits included)."""
    digest = hashlib.sha256(f"{int(seed)}/{stream}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & ((1 << 63) - 1)


def zipf_pmf(vocab: int, s: float) -> np.ndarray:
    """float64 [vocab]: Zipf(s) over ranks 1..vocab."""
    pmf = np.arange(1, vocab + 1, dtype=np.float64) ** -float(s)
    return pmf / pmf.sum()


def term_counts(total: int, pmf: np.ndarray) -> np.ndarray:
    """int64 [vocab]: tokens of each rank among ``total``, ``total * pmf``
    rounded by largest remainders (ties to the lower rank)."""
    want = total * pmf
    counts = np.floor(want).astype(np.int64)
    short = total - int(counts.sum())
    if short:
        counts[np.argsort(-(want - counts), kind="stable")[:short]] += 1
    return counts


class Segment(NamedTuple):
    lens: torch.Tensor  # int64 [n]: tokens of each doc
    starts: torch.Tensor  # int64 [n]: each doc's first token
    tids: torch.Tensor  # int32 [N]: term ids in (doc asc, pos asc) order


class Corpus(NamedTuple):
    vocab: int
    segments: List[Segment]
    bases: List[int]  # each segment's first global doc

    @property
    def num_docs(self) -> int:
        return sum(len(s.lens) for s in self.segments)

    @property
    def num_tokens(self) -> int:
        return sum(len(s.tids) for s in self.segments)


def generate(law: dict, sizes: Sequence[int], seed: int, device) -> Corpus:
    """The corpus of ``sizes`` docs a segment under ``law`` (``vocab``,
    ``zipf_s``, ``doc_len``), drawn for ``seed`` on ``device``."""
    device = torch.device(device)
    vocab = int(law["vocab"])
    lo, hi = (int(x) for x in law["doc_len"])
    pmf = zipf_pmf(vocab, float(law["zipf_s"]))
    g = torch.Generator(device=device)
    g.manual_seed(stream_seed(seed, "terms"))
    label = torch.randperm(vocab, generator=g, device=device).to(torch.int32)
    segments, bases, base = [], [], 0
    for si, n in enumerate(sizes):
        g = torch.Generator(device=device)
        g.manual_seed(stream_seed(seed, f"corpus/{si}"))
        lens = lo + torch.arange(int(n), device=device) % (hi - lo)
        lens = lens[torch.randperm(int(n), generator=g, device=device)]
        counts = torch.from_numpy(term_counts(int(lens.sum()), pmf)).to(device)
        ranked = torch.repeat_interleave(label, counts)
        del counts
        shuffle = torch.randperm(len(ranked), generator=g, device=device)
        tids = ranked[shuffle]
        del ranked, shuffle
        segments.append(Segment(lens, torch.cumsum(lens, 0) - lens, tids))
        bases.append(base)
        base += int(n)
    return Corpus(vocab, segments, bases)


def doc_freqs(corpus: Corpus) -> np.ndarray:
    """int64 [vocab]: the docs of the whole index that hold each term."""
    v = corpus.vocab
    df = None
    for seg in corpus.segments:
        n = len(seg.lens)
        for d0 in range(0, n, DOC_CHUNK):
            d1 = min(n, d0 + DOC_CHUNK)
            a = int(seg.starts[d0])
            b = int(seg.starts[d1 - 1] + seg.lens[d1 - 1])
            doc = torch.repeat_interleave(
                torch.arange(d0, d1, device=seg.tids.device), seg.lens[d0:d1]
            )
            key = torch.unique(doc * v + seg.tids[a:b])
            part = torch.bincount(key % v, minlength=v)
            df = part if df is None else df + part
    return df.cpu().numpy()


def ranked_terms(df: np.ndarray) -> np.ndarray:
    """Term ids by doc count descending, ties by term id ascending:
    ``ranked_terms(df)[r]`` is the term of df rank ``r``."""
    return np.lexsort((np.arange(len(df)), -df))
