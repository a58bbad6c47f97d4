"""Deep top-k of batched disjunctions (``QueryBatch.prepare(seg, k)
.run()`` and ``.prepare_all(k).run()``) against a plain BM25 oracle.

The queries are shaped as a first-stage retrieval's questions: ORs of 3
to 6 terms, one of high doc frequency (a dense-grid term, so the plan is
``gridmix``) and the rest of middling and low frequency; a few have no
grid term at all (``sort``). k = 200 and k = 1,000 lie above the skyline
tier's ``K_MAX`` (128), and 1,000 above the 256 winners that K4 ranks by
counting (``irs_topk.cu:K4_RANK_MAX``), so on the card it sorts them.

The oracle is plain torch in float64 over the corpus's token arrays
(``bench_mix.token_stream``): nothing of the port's index, planner or
kernels. Served docs have to come in the oracle's exact order, and their
scores within 1e-5 relative: float32 arithmetic on this index errs near
1e-7, bfloat16 near 1e-2 (``test_the_tolerance_refuses_bfloat16``).
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from iresearch_tpu_torch import bench_mix  # noqa: E402
from iresearch_tpu_torch.exec import batch as B  # noqa: E402
from iresearch_tpu_torch.exec.batch import QueryBatch  # noqa: E402
from iresearch_tpu_torch.exec.skyline import K_MAX  # noqa: E402
from iresearch_tpu_torch.index.segment import SegmentReader  # noqa: E402
from iresearch_tpu_torch.search import filters as F  # noqa: E402
from iresearch_tpu_torch.search.scorers import BM25  # noqa: E402

K1, BB = 0.82, 0.68  # MS MARCO passage's tuned BM25
DOCS = (12_000, 3_000)  # two segments: the index entry; the first alone: the segment entry
RTOL = 1e-5
# df ranks: high terms lie on the dense grid (df >= docs / 128), the rest
# do not
BANDS = {"high": (3, 60), "med": (700, 2_000), "low": (2_000, 8_000)}
SHAPES = [("high", "med", "low"), ("high", "med", "low", "low"),
          ("high", "med", "med", "low", "low"), ("high", "med", "med", "low", "low", "low")]


class Oracle:
    """Plain BM25 over the index's token arrays, index-wide statistics, in
    ``dtype``."""

    def __init__(self, dtype=torch.float64):
        docs, tids = [], []
        base = 0
        for si, n in enumerate(DOCS):
            t, d, _pos = bench_mix.token_stream(n, bench_mix.SEED + si)
            tids.append(torch.from_numpy(t))
            docs.append(torch.from_numpy(d).long() + base)
            base += n
        self.tids, self.docs = torch.cat(tids), torch.cat(docs)
        self.n = base
        self.dl = torch.bincount(self.docs, minlength=self.n)
        self.avgdl = len(self.tids) / self.n
        self.dtype = dtype

    def df_ranked(self):
        """Term ids by doc count desc, ties by id asc."""
        key = torch.unique(self.docs * bench_mix.VOCAB + self.tids)
        df = torch.bincount(key % bench_mix.VOCAB, minlength=bench_mix.VOCAB).numpy()
        return np.lexsort((np.arange(len(df)), -df))

    def term(self, t: int):
        d, tf = torch.unique(self.docs[self.tids == t], return_counts=True)
        idf = math.log1p((self.n - len(d) + 0.5) / (len(d) + 0.5))
        f, dl = tf.to(self.dtype), self.dl[d].to(self.dtype)
        norm = f + K1 * (1 - BB) + (K1 * BB / self.avgdl) * dl
        return d, (K1 + 1) * idf * f / norm

    def top(self, terms, k: int, segment=None):
        """(docs, scores) of the OR of ``terms`` by (score desc, doc asc);
        ``segment`` = (first, end) keeps that segment's docs, local."""
        parts = [self.term(t) for t in terms]
        d = torch.cat([p[0] for p in parts])
        s = torch.cat([p[1] for p in parts])
        docs, inv = torch.unique(d, return_inverse=True)
        score = torch.zeros(len(docs), dtype=self.dtype).index_add_(0, inv, s)
        if segment is not None:
            keep = (docs >= segment[0]) & (docs < segment[1])
            docs, score = docs[keep] - segment[0], score[keep]
        o = torch.sort(score, descending=True, stable=True).indices[:k]
        return docs[o], score[o]


@pytest.fixture(scope="module")
def index():
    oracle = Oracle()
    segs = [SegmentReader(f"q{si}", bench_mix.build_segment_data(n, bench_mix.SEED + si))
            for si, n in enumerate(DOCS)]
    ranked = oracle.df_ranked()
    rng = np.random.default_rng(24)
    queries = []
    for i in range(40):
        shape = SHAPES[i % len(SHAPES)]
        if i % 10 == 9:  # no grid term: the sort tier
            shape = ("med",) + shape[1:]
        terms = []
        for band in shape:
            a, b = BANDS[band]
            while True:
                t = int(ranked[rng.integers(a, b)])
                if t not in terms:
                    break
            terms.append(t)
        queries.append(terms)
    return oracle, segs, queries


def _filter(terms):
    return F.Or(*[F.ByTerm("body", b"t%06d" % t) for t in terms])


def _check(got_vals, got_docs, want_docs, want_scores, k):
    n = len(want_docs)
    vals = np.asarray(got_vals, np.float64)
    assert np.isfinite(vals[:n]).all() and not np.isfinite(vals[n:k]).any()
    assert np.asarray(got_docs)[:n].tolist() == want_docs.tolist()
    np.testing.assert_allclose(vals[:n], want_scores.numpy(), rtol=RTOL, atol=0)


@pytest.mark.parametrize("k", [200, 1000])
def test_segment_batch_matches_the_oracle(index, k):
    """``prepare(0, k).run_grouped()`` on one segment, every group's
    answers in the oracle's order; most plans ``gridmix``."""
    oracle, segs, queries = index
    before = B.tier_stats()
    qb = QueryBatch([_filter(t) for t in queries], segs, BM25(k=K1, b=BB), device="cpu")
    prep = qb.prepare(0, k)
    after = B.tier_stats()
    modes = {m: n - before["mode_queries"].get(m, 0) for m, n in after["mode_queries"].items()}
    assert modes.get("gridmix", 0) >= 30 and modes.get("sort", 0) >= 2, modes
    assert k > K_MAX and sum(modes.values()) == len(queries)
    for (vals, docs), qis in prep.run_grouped():
        for j, qi in enumerate(qis):
            want_d, want_s = oracle.top(queries[qi], k, segment=(0, DOCS[0]))
            _check(vals[j], docs[j], want_d, want_s, k)


@pytest.mark.parametrize("k", [200, 1000])
def test_index_batch_matches_the_oracle(index, k):
    """``prepare_all(k).run()`` over two segments: the global top k."""
    oracle, segs, queries = index
    qb = QueryBatch([_filter(t) for t in queries], segs, BM25(k=K1, b=BB), device="cpu")
    vals, docs = qb.prepare_all(k).run()
    for qi, terms in enumerate(queries):
        want_d, want_s = oracle.top(terms, k)
        _check(vals[qi], docs[qi], want_d, want_s, k)


def test_the_tolerance_refuses_bfloat16(index):
    """The oracle in bfloat16 misses the float64 scores by far more than
    ``RTOL``, so a path in half precision fails these tests."""
    oracle, _segs, queries = index
    low = Oracle(torch.bfloat16)
    worst = 0.0
    for terms in queries[:8]:
        want_d, want_s = oracle.top(terms, 1000)
        docs, sc = low.top(terms, len(oracle.dl))
        at = {int(d): float(s) for d, s in zip(docs, sc.double())}
        got = torch.tensor([at[int(d)] for d in want_d], dtype=torch.float64)
        worst = max(worst, float(((got - want_s).abs() / want_s).max()))
    assert worst > 100 * RTOL


@pytest.mark.cuda
@pytest.mark.parametrize("k", [200, 1000])
def test_segment_batch_on_the_card(index, k):
    """The same batch on the card, fused (one CUDA graph, K4 in every
    select): the oracle's order and scores."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    oracle, segs, queries = index
    qb = QueryBatch([_filter(t) for t in queries], segs, BM25(k=K1, b=BB), device="cuda")
    for _ in range(2):  # a capture, then a hit on a fresh batch of the same queries
        for (vals, docs), qis in qb.prepare(0, k).run_grouped():
            vals, docs = vals.cpu(), docs.cpu()
            for j, qi in enumerate(qis):
                want_d, want_s = oracle.top(queries[qi], k, segment=(0, DOCS[0]))
                _check(vals[j], docs[j], want_d, want_s, k)
