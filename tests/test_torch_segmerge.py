"""The port's cross-segment merge on the device (``exec/segmerge.py``,
``QueryBatch.prepare_all``) vs the JAX package on the CPU: the counterparts
of ``tests/test_segmerge.py``.

The JAX package writes each index (seeded numpy text, three segments of
unequal sizes; a 60-doc segment beside a 4-doc one) and the port gets the
segments through ``carry`` and the filters through ``to_port``. The merged
batch is held against the JAX ``prepare_all(k).run()`` and against the host
merge of ``QueryBatch.search``: docs equal, in (score desc, global doc asc)
order, scores to rtol 1e-5. With TFIDF the two packages' scores differ in
the last ulp on the CPU (XLA computes ``sqrt(f) / sqrt(dl)`` with a
reciprocal square root), so a tie in one is a near-tie in the other:
against the JAX package docs may then swap inside near-ties
(``assert_topk_near``); against the port's own host merge they are equal.

``test_fused_pass_equals_per_segment_dispatch`` holds ``run(fused=True)``
(every segment's groups and the merge as one pass, kept in
``_FUSED_CACHE``; one CUDA graph on the card, the entry's bodies run
eagerly over its copy of the packed buffers on the CPU) against
``run(fused=False)`` and the JAX ``run(fused=True)``.
``test_equal_shape_segments_reuse_fused_entry`` is the cache-reuse half of
``test_equal_shape_segments_share_fused_executable``: a second
``prepare_all`` finds the same entry. Its other half, one key shared by
equal-shape segments (``_joint_pad``), has no counterpart: a graph reads
each segment's own pool addresses, so the port's keys hold them.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from iresearch_tpu.exec import segmerge as jsm  # noqa: E402
from iresearch_tpu.exec.batch import QueryBatch as JaxQueryBatch  # noqa: E402
from iresearch_tpu.index.reader import DirectoryReader  # noqa: E402
from iresearch_tpu.index.writer import Field, IndexWriter, IndexWriterOptions  # noqa: E402
from iresearch_tpu.search import filters as F  # noqa: E402
from iresearch_tpu.search.scorers import BM25, TFIDF  # noqa: E402
from iresearch_tpu.store.directory import MemoryDirectory  # noqa: E402
from iresearch_tpu_torch.exec import batch as tb  # noqa: E402
from iresearch_tpu_torch.exec import segmerge as tsm  # noqa: E402
from iresearch_tpu_torch.exec.batch import QueryBatch  # noqa: E402
from test_torch_carry import carried, to_port  # noqa: E402
from test_torch_exec import assert_topk_near  # noqa: E402

CPU = torch.device("cpu")
WORDS = ["one", "two", "three", "four", "five",
         "six", "seven", "eight", "nine", "ten"]


def _index(ndocs, seed, zipf, commits=(), tail=0):
    rng = np.random.default_rng(seed)
    d = MemoryDirectory()
    with IndexWriter(d, IndexWriterOptions(invert_backend="numpy")) as w:
        for i in range(ndocs):
            n = int(rng.integers(2, 15))
            idx = np.minimum(rng.zipf(zipf, size=n) - 1, len(WORDS) - 1)
            w.insert([Field("body", " ".join(WORDS[j] for j in idx),
                            analyzer="segmentation")])
            if i in commits:
                w.commit()
        w.commit()
        for i in range(tail):  # a tail segment smaller than k
            w.insert([Field("body", " ".join(WORDS[j % 5] for j in range(i, i + 4)),
                            analyzer="segmentation")])
        if tail:
            w.commit()
    return carried(DirectoryReader.open(d))


@pytest.fixture(scope="module")
def segs():
    """``tests/test_segmerge.py``'s reader: three segments of 91, 120 and
    89 docs."""
    out = _index(300, 11, 1.5, commits=(90, 210))
    assert [sr.num_docs for sr in out.port] == [91, 120, 89]
    return out


def _filters():
    return (
        [F.ByTerm("body", w) for w in WORDS[:6]]
        + [F.Or(F.ByTerm("body", "one"), F.ByTerm("body", "nine"))]
        + [F.And(F.ByTerm("body", "one"), F.ByTerm("body", "three"))]
        + [F.Or(*[F.ByTerm("body", w) for w in WORDS[:4]])]
    )


def _port_batch(segs, scorer):
    return QueryBatch(to_port(tuple(_filters())), segs.port, to_port(scorer),
                      wand=True, device=CPU)


def _assert_rows_equal(gv, gd, wv, wd, near_ties=False):
    if near_ties:
        for q in range(len(gv)):
            assert_topk_near((gv[q], gd[q]), (wv[q], wd[q]))
        return
    fin = np.isfinite(wv)
    np.testing.assert_array_equal(np.isfinite(gv), fin)
    np.testing.assert_array_equal(gd[fin], wd[fin])
    np.testing.assert_allclose(gv[fin], wv[fin], rtol=1e-5, atol=0.0)


@pytest.mark.parametrize("scorer", [BM25(), TFIDF()], ids=["bm25", "tfidf"])
def test_merged_batch_equals_jax_and_host_merge(segs, scorer):
    k = 7
    qb = _port_batch(segs, scorer)
    mb = qb.prepare_all(k)
    vals, docs = mb.run()
    assert vals.dtype == torch.float32 and docs.dtype == torch.int32
    assert vals.shape == docs.shape == (len(_filters()), k)
    wv, wd = JaxQueryBatch(_filters(), segs.jax, scorer, wand=True).prepare_all(k).run()
    _assert_rows_equal(vals.numpy(), docs.numpy(), np.asarray(wv), np.asarray(wd),
                       near_ties=isinstance(scorer, TFIDF))
    got, ref = mb.search(k), qb.search(k)
    for qi, (g, r) in enumerate(zip(got, ref)):
        assert [d for d, _v in g] == [d for d, _v in r], qi
        np.testing.assert_allclose([v for _d, v in g], [v for _d, v in r], rtol=1e-5)
    # on CPU tensors the kernels' wrappers take their plain versions
    pv, pd = mb.run(plain=True)
    assert torch.equal(pv, vals) and torch.equal(pd, docs)


def test_prepare_all_with_aux_filters_equals_jax_and_host_merge(segs):
    """Filters that the planner evaluates on the host (a negation, a
    prefix) go through ``prepare_all`` like plain terms."""
    filters = [
        F.And(F.ByTerm("body", "one"), F.Not(F.ByTerm("body", "two"))),
        F.ByPrefix("body", "t"),
        F.Or(F.ByPrefix("body", "f"), F.ByTerm("body", "nine")),
    ]
    qb = QueryBatch(to_port(tuple(filters)), segs.port, to_port(BM25()), device=CPU)
    got = qb.prepare_all(10).search(10)
    want = JaxQueryBatch(filters, segs.jax, BM25()).prepare_all(10).search(10)
    for g, w, r in zip(got, want, qb.search(10)):
        assert [d for d, _v in g] == [d for d, _v in w] == [d for d, _v in r]
        np.testing.assert_allclose([v for _d, v in g], [v for _d, v in w], rtol=1e-5)
        np.testing.assert_allclose([v for _d, v in g], [v for _d, v in r], rtol=1e-5)


def test_merged_batch_deterministic_tie_order(segs):
    """Equal-score docs come out (score desc, global doc asc), across
    segments too."""
    res = _port_batch(segs, BM25()).prepare_all(10).search(10)
    ties = 0
    for q in res:
        for (d0, v0), (d1, v1) in zip(q, q[1:]):
            assert v0 > v1 or (v0 == v1 and d0 < d1), q
            ties += v0 == v1
    assert ties


def test_tiny_segment_pads_to_requested_k():
    """A segment whose padded doc count is below the requested k clamps its
    groups' top-k to k' < k; the merge pads them back to k with (-inf, 0)."""
    segs = _index(60, 3, 1.4, tail=4)
    assert [sr.num_docs for sr in segs.port] == [60, 4]
    qb = _port_batch(segs, BM25())
    mb = qb.prepare_all(10)
    assert min(g[0].shape[1] for g, _q in mb.preps[1].run_grouped()) < 10
    vals, docs = mb.run()
    assert vals.shape == (len(_filters()), 10)
    wv, wd = JaxQueryBatch(_filters(), segs.jax, BM25(), wand=True).prepare_all(10).run()
    _assert_rows_equal(vals.numpy(), docs.numpy(), np.asarray(wv), np.asarray(wd))
    for g, r in zip(mb.search(10), qb.search(10)):
        assert [d for d, _v in g] == [d for d, _v in r]
    # k=None resolves to the widest group
    assert tsm.MergedBatch(mb.preps, [60, 4], device=CPU).run()[0].shape[1] == 10


def test_merged_batch_rejects_int32_overflow():
    with pytest.raises(ValueError, match="2\\^31"):
        tsm.MergedBatch([object(), object()], [2**30, 2**30 + 7], device=CPU)
    with pytest.raises(ValueError, match="per segment"):
        tsm.MergedBatch([object()], [5, 6], device=CPU)


@pytest.mark.parametrize("seed,sizes,k", [
    (0, ((5, 3), (8,), (2, 2, 4)), 6),  # three segments, 8 queries
    (1, ((4,), (4,)), 10),  # every group narrower than k
    (2, ((1, 1), (2,), (1, 1), (2,), (2,)), 3),  # five segments
])
def test_merge_body_matches_jax(seed, sizes, k):
    """``merge_body`` against the JAX ``_merge_body`` on seeded arrays:
    groups of differing widths k' <= k, scores drawn from few values so
    that ties cross segments, -inf non-matches, random permutations."""
    rng = np.random.default_rng(seed)
    q = sum(sizes[0])
    gvs, gds = [], []
    for groups in sizes:
        assert sum(groups) == q
        vs, ds = [], []
        for qg in groups:
            kk = int(rng.integers(1, k + 1))
            v = rng.integers(0, 4, size=(qg, kk)).astype(np.float32)
            v[rng.random((qg, kk)) < 0.2] = -np.inf
            v = -np.sort(-v, axis=1)
            d = np.stack([rng.choice(50, size=kk, replace=False) for _ in range(qg)])
            vs.append(v)
            ds.append(d.astype(np.int32))
        gvs.append(vs)
        gds.append(ds)
    perms = np.stack([rng.permutation(q) for _ in sizes]).astype(np.int32)
    bases = (np.arange(len(sizes)) * 50).astype(np.int32)
    wv, wd = jsm._merge_body(
        tuple(tuple(jnp.asarray(g) for g in v) for v in gvs),
        tuple(tuple(jnp.asarray(g) for g in d) for d in gds),
        jnp.asarray(perms), jnp.asarray(bases), k=k,
    )
    gv, gd = tsm.merge_body(
        tuple(tuple(torch.from_numpy(g) for g in v) for v in gvs),
        tuple(tuple(torch.from_numpy(g) for g in d) for d in gds),
        torch.from_numpy(perms), torch.from_numpy(bases), k=k,
    )
    assert gv.shape == gd.shape == (q, k)
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))


def test_perm_of_inverts_the_group_order(segs):
    prep = _port_batch(segs, BM25()).prepare(1, 7)
    order = np.concatenate([np.asarray(qis) for _t, qis, *_r in prep.calls])
    np.testing.assert_array_equal(order[tsm.perm_of(prep)], np.arange(len(order)))
    assert len(prep.calls) > 1


@pytest.mark.parametrize("scorer", [BM25(), TFIDF()], ids=["bm25", "tfidf"])
def test_fused_pass_equals_per_segment_dispatch(segs, scorer):
    """``run(fused=True)``, every segment's groups and the merge as one
    pass, equals ``run(fused=False)`` bit for bit and the JAX package's
    ``MergedBatch.run(fused=True)``; it is cached under ``("segfused",
    segment keys, k)``, and a fresh ``prepare_all`` of the same queries
    reuses that entry."""
    tb.clear_fused_cache()
    k = 7
    mb = _port_batch(segs, scorer).prepare_all(k)
    v1, d1 = mb.run(fused=True)
    v0, d0 = mb.run(fused=False)
    assert torch.equal(v1, v0) and torch.equal(d1, d0)
    fkey = ("segfused", tuple(p._key for p in mb.preps), k)
    assert mb.fused_key() == fkey and list(tb._FUSED_CACHE) == [fkey]
    entry = tb._FUSED_CACHE[fkey]
    v2, d2 = _port_batch(segs, scorer).prepare_all(k).run(fused=True)
    assert tb._FUSED_CACHE[fkey] is entry and len(tb._FUSED_CACHE) == 1
    assert torch.equal(v2, v0) and torch.equal(d2, d0)
    wv, wd = JaxQueryBatch(_filters(), segs.jax, scorer, wand=True).prepare_all(k).run(fused=True)
    _assert_rows_equal(v1.numpy(), d1.numpy(), np.asarray(wv), np.asarray(wd),
                       near_ties=isinstance(scorer, TFIDF))
    tb.clear_fused_cache()


def _equal_shape_index():
    """``tests/test_segmerge.py``'s three near-equal segments: the same
    200-doc stream each, segment 1 with 24 docs more."""
    d = MemoryDirectory()
    with IndexWriter(d, IndexWriterOptions(invert_backend="numpy")) as w:
        for s in range(3):
            rng = np.random.default_rng(5)
            for _i in range(200):
                n = int(rng.integers(4, 15))
                idx = np.minimum(rng.zipf(1.4, size=n) - 1, len(WORDS) - 1)
                w.insert([Field("body", " ".join(WORDS[j] for j in idx),
                                analyzer="segmentation")])
            if s == 1:
                for i in range(24):
                    w.insert([Field("body", " ".join(WORDS[(i + j) % 6] for j in range(6)),
                                    analyzer="segmentation")])
            w.commit()
    return carried(DirectoryReader.open(d))


def test_equal_shape_segments_reuse_fused_entry():
    """A second ``prepare_all`` of the same queries over the equal-shape
    index finds the first one's ``("segfused", ...)`` entry, ``is``-identical,
    and returns the same result as the host merge. Where the JAX package
    gives the three segments one key, the port gives each its own."""
    segs = _equal_shape_index()
    tb.clear_fused_cache()
    jmb = JaxQueryBatch(_filters(), segs.jax, BM25(), wand=True).prepare_all(7)
    assert len({p._key for p in jmb.preps}) == 1
    qb = _port_batch(segs, BM25())
    mb = qb.prepare_all(7)
    assert len({p._key for p in mb.preps}) == 3
    first = mb.run()
    entry = tb._FUSED_CACHE[mb.fused_key()]
    mb2 = _port_batch(segs, BM25()).prepare_all(7)
    assert mb2.fused_key() == mb.fused_key()
    second = mb2.run()
    assert tb._FUSED_CACHE[mb.fused_key()] is entry and len(tb._FUSED_CACHE) == 1
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    for g, r in zip(mb2.search(7), qb.search(7)):
        assert [d for d, _v in g] == [d for d, _v in r]
    tb.clear_fused_cache()
