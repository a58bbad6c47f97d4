"""The port's single-query executor and its single-segment tiers vs the JAX
package on the CPU.

Three kinds of check, all on seeded readers:

* each body (fold, decode, dense span, segment fold, WAND, direct, sort,
  join and its probes, view merge, gridmix, WAND θ, candidate body,
  dslice) gets the JAX ``DeviceQuery``'s own device inputs of one plan,
  as numpy, and is compared with the JAX function (XLA decode);
* every tier through both entry points: ``DeviceQuery.execute_segment``
  and ``QueryBatch.prepare(0, k).run()`` against the JAX package's, with
  the JAX decode through XLA and through K3's Pallas body (interpret
  mode), and against the numpy oracle (``HostQuery``);
* the global entry points ``top_k``/``search_device``/``QueryBatch.search``.

Tolerances: scores to rtol 1e-5 (atol 1e-6), the exactness gate; docs
equal except for swaps inside near-ties. A tie group that reaches the end
of a full top-k list may hold different docs in the two lists: on the CPU
XLA computes TFIDF's ``w * sqrt(f) / sqrt(dl)`` with a reciprocal square
root, 1 ulp off the numpy oracle, which the port matches. Elementwise
bodies with no scatter are held to rtol 1e-6, decoded docs and masks
exactly.
"""

import contextlib
from collections import Counter

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from iresearch_tpu.exec import executor as jex  # noqa: E402
from iresearch_tpu.index.reader import DirectoryReader  # noqa: E402
from iresearch_tpu.index.writer import Field, IndexWriter, IndexWriterOptions  # noqa: E402
from iresearch_tpu.search import filters as F  # noqa: E402
from iresearch_tpu.search.host_eval import HostQuery  # noqa: E402
from iresearch_tpu.search.scorers import BM25, TFIDF  # noqa: E402
from iresearch_tpu.store.directory import MemoryDirectory  # noqa: E402
from iresearch_tpu_torch import bench_mix  # noqa: E402
from iresearch_tpu_torch.exec import candidates as tc  # noqa: E402
from iresearch_tpu_torch.exec import executor as tex  # noqa: E402
from iresearch_tpu_torch.exec.batch import QueryBatch, group_call  # noqa: E402

CPU = torch.device("cpu")


# --- readers ---------------------------------------------------------------


def _reader(ndocs, nwords, prefix, zipf, seed, maxlen, deletes=(), version=None):
    words = [f"{prefix}{i:02d}" for i in range(nwords)]
    rng = np.random.default_rng(seed)
    d = MemoryDirectory()
    opts = dict(invert_backend="numpy")
    if version is not None:
        opts["format_version"] = version
    with IndexWriter(d, IndexWriterOptions(**opts)) as w:
        for i in range(ndocs):
            n = int(rng.integers(2, maxlen))
            idx = np.minimum(rng.zipf(zipf, size=n) - 1, nwords - 1)
            w.insert([
                Field("body", " ".join(words[j] for j in idx), analyzer="segmentation"),
                Field("id", str(i), index=True, store=True),
            ])
        w.commit()
        for i in deletes:
            w.remove(F.ByTerm("id", str(i)))
        if deletes:
            w.commit()
    return DirectoryReader.open(d)


@pytest.fixture(scope="module")
def zipf_reader():
    """``tests/test_wand.py``'s corpus: 3000 docs, 40 words, Zipf(1.3)."""
    return _reader(3000, 40, "w", 1.3, 21, 40)


@pytest.fixture(scope="module")
def cand_reader():
    """``tests/test_candidates.py``'s corpus: 800 docs, two deleted."""
    return _reader(800, 30, "t", 1.4, 31, 24, deletes=(13, 400))


@pytest.fixture(scope="module")
def legacy_reader():
    """The same corpus written as format v4: no inline norm pools, so
    every group decodes with bn == -1 and reads norms[docs]."""
    r = _reader(800, 30, "t", 1.4, 31, 24, deletes=(13, 400), version="iresearch_tpu/4")
    assert r.segments[0].data.fields["body"].nrm_words is None
    return r


@pytest.fixture(scope="module")
def bench20k():
    """The bench corpus law at 20k docs: High/Med terms on the dense grid,
    Low terms sparse (gridmix, join with grid probes, dslice)."""
    from iresearch_tpu.index.segment import SegmentReader

    sr = SegmentReader("exec20k", bench_mix.build_segment_data(20_000))
    mix = bench_mix.task_mix(sr)
    cats = {c: [f for cc, f in mix if cc == c] for c in ("HighTerm", "MedTerm", "LowTerm")}
    return sr, cats


# --- planner knobs, decode route ---------------------------------------------


@pytest.fixture()
def knobs():
    """``knobs(**kv)`` sets planner knobs until the test ends
    (``bench_mix.planner_knobs``, which clears the plan cache around
    them: its key holds no knob)."""
    with contextlib.ExitStack() as stack:
        yield lambda **kv: stack.enter_context(bench_mix.planner_knobs(**kv))


FORCED = dict(SORT_MAX_RATIO=1e9, JOIN_MAX_RATIO=1e9, USE_DENSE_TERMS=False)


@pytest.fixture(params=[False, True], ids=["xla_decode", "pallas_decode"])
def jax_decode(request, monkeypatch):
    """The JAX side's block decode: XLA, or K3's Pallas body in interpret
    mode. The flag is read while tracing, so the jit caches are cleared
    around the Pallas route."""
    if request.param:
        jax.clear_caches()
        monkeypatch.setattr(jex, "_USE_PALLAS_DECODE", True)
    yield request.param
    if request.param:
        jax.clear_caches()


# --- comparison ---------------------------------------------------------------


def _canonical(vals, docs):
    vals, docs = np.asarray(vals), np.asarray(docs)
    o = np.lexsort((docs, -vals))
    return vals[o], docs[o]


def assert_topk_near(got, want, rel=1e-5, abs_=1e-6):
    """(vals, docs) of the port vs a reference: the same finite count,
    scores rank by rank within rel, docs equal except inside near-ties.
    A doc missing from the other list is allowed only in a tie group that
    reaches the end of a full list."""
    gv, gd = (np.asarray(a) for a in got)
    np.testing.assert_array_equal(_canonical(gv, gd)[1], gd)  # port order
    wv, wd = _canonical(*want)
    fin = np.isfinite(wv)
    np.testing.assert_array_equal(np.isfinite(gv), fin)
    full = bool(fin.all())
    gv, gd, wv, wd = gv[fin], gd[fin], wv[fin], wd[fin]
    np.testing.assert_allclose(gv, wv, rtol=rel, atol=abs_)

    def close(a, b):
        return abs(a - b) <= abs_ + rel * abs(b)

    gs = dict(zip(gd.tolist(), gv.tolist()))
    ws = dict(zip(wd.tolist(), wv.tolist()))
    for g, w, s in zip(gd.tolist(), wd.tolist(), wv.tolist()):
        if g == w:
            continue
        for doc, other in ((g, ws), (w, gs)):
            if doc in other:
                assert close(other[doc], s), (doc, other[doc], s)
            else:
                assert full and close(s, wv[-1]), (g, w, s, wv[-1])


def _oracle(flt, segs, scorer, k):
    hr = HostQuery(flt, segs, scorer).execute(0)
    docs = np.flatnonzero(hr.match)
    sc = hr.score[docs].astype(np.float32)
    o = np.lexsort((docs, -sc))[:k]
    vals = np.full(k, -np.inf, np.float32)
    out = np.zeros(k, np.int32)
    vals[: len(o)], out[: len(o)] = sc[o], docs[o]
    return vals, out


def check_single(flt, segs, scorer, k, *, oracle=True, **kw):
    """The port's DeviceQuery vs the JAX package's (and the oracle) on
    segment 0; returns the tier the port took."""
    from iresearch_tpu.exec import DeviceQuery as JaxDeviceQuery

    kw.setdefault("device_phrase", False)
    want = JaxDeviceQuery(flt, segs, scorer, **kw).execute_segment(0, k)
    tq = tex.DeviceQuery(flt, segs, scorer, device=CPU, **kw)
    got = tq.execute_segment(0, k)
    assert_topk_near(got, want)
    if oracle:
        ov, od = _oracle(flt, segs, scorer, len(got[0]))
        assert_topk_near(got, (ov, od))
    # on CPU tensors the kernel wrappers take their plain versions
    pv, pd = tq.execute_segment(0, k, plain=True)
    np.testing.assert_array_equal(pv, got[0])
    np.testing.assert_array_equal(pd, got[1])
    return tq.call(0, k)[0]


def check_batch(filters, segs, scorer, k, **kw):
    """The port's QueryBatch vs the JAX package's on segment 0; returns
    the number of queries per tier."""
    from iresearch_tpu.exec.batch import QueryBatch as JaxQueryBatch

    want = JaxQueryBatch(filters, segs, scorer, **kw).prepare(0, k).run()
    prep = QueryBatch(filters, segs, scorer, device=CPU, **kw).prepare(0, k)
    got = prep.run()
    assert len(got) == len(want) == len(filters)
    for (gv, gd), (wv, wd) in zip(got, want):
        assert_topk_near((gv.numpy(), gd.numpy()), (wv, wd))
    tiers = Counter()
    for tier, qis, *_r in prep.calls:
        tiers[tier] += len(qis)
    return tiers


def T(t):
    return F.ByTerm("body", t)


# --- tiers through both entry points -----------------------------------------

FOLD_QUERIES = [
    T("w00"),
    F.Not(T("w02")),
    F.Or(F.And(T("w00"), F.Not(T("w01"))), F.Not(T("w05"))),
    F.Or(T("w00"), T("w01"), merge="max"),
    F.Or(F.And(T("w03"), T("w04"), merge="min"), F.Not(T("w06"))),
    F.Or(T("w00"), F.Not(T("w09"))),
    F.All(),
    F.Empty(),
]


@pytest.mark.parametrize("scorer", [BM25(), TFIDF()], ids=["bm25", "tfidf"])
def test_fold_tier_matches_jax(zipf_reader, jax_decode, scorer):
    segs = list(zipf_reader.segments)
    tiers = {check_single(f, segs, scorer, 10) for f in FOLD_QUERIES}
    assert tiers == {"fold"}, tiers
    # the batch scans single grid terms with no single-span gate
    assert check_batch(FOLD_QUERIES, segs, scorer, 10) == {"fold": 7, "scan": 1}


AUX_QUERIES = [
    F.ByPhrase("body", ["t00", "t01"]),
    F.And(T("t00"), F.ByPhrase("body", ["t01", "t02"])),
    F.Or(T("t05"), F.ByPhrase("body", ["t00", "t00"]), min_match=1),
]


def test_aux_tier_matches_jax(cand_reader, jax_decode):
    """Phrases evaluated on the host as aux leaves (device_phrase=False),
    their sparse (docs, scores) densified on the device; the reader has
    deletes."""
    segs = list(cand_reader.segments)
    for k in (1, 10):
        assert {check_single(f, segs, BM25(), k) for f in AUX_QUERIES} == {"aux"}
    assert set(check_batch(AUX_QUERIES, segs, BM25(), 10)) == {"aux"}


# trees the fused scan does not take (it takes single-span leaves)
WAND_QUERIES = [
    T("w00"),
    T("w05"),
    F.And(
        F.Or(T("w00"), T("w04")),
        F.ByTerms("body", [("w01", 1.0), ("w06", 2.0)]),
    ),
    F.Or(F.Or(T("w00"), T("w01")), T("w02"), min_match=2),
]


@pytest.mark.parametrize("mode", ["exact", "strict", "approx"])
def test_wand_tier_matches_jax(zipf_reader, knobs, jax_decode, mode):
    """Block-max WAND over dense-grid spans (``tests/test_wand.py`` turns
    the join and merge tiers off the same way)."""
    knobs(JOIN_MAX_SPANS=0)
    segs = list(zipf_reader.segments)
    kw = dict(wand=True, wand_sample=8, wand_mode=mode)
    for k in (1, 10):
        tiers = {
            check_single(f, segs, BM25(), k, oracle=mode == "exact", **kw)
            for f in WAND_QUERIES
        }
        assert tiers == {"wand"}, tiers
    # the batch sends the single-span terms to the fused scan
    assert check_batch(WAND_QUERIES, segs, BM25(), 10, **kw) == {"scan": 2, "wand": 2}


CAND_QUERIES = [
    T("t00"),
    F.Or(T("t00"), T("t03")),
    F.And(T("t00"), T("t05")),
    F.And(F.Or(T("t01"), T("t06")), T("t03")),
    F.And(T("t02"), F.Not(T("t00"))),
    F.Or(T("t00"), T("t01"), min_match=2),
    F.And(F.Or(T("t00"), T("t04")), F.Or(T("t02"), T("t06"))),
    F.Or(
        F.ByTerms("body", [("t00", 1.0), ("t05", 2.0)]),
        F.ByPrefix("body", "t1", scored_terms_limit=5),
        min_match=1, merge="max",
    ),
]


@pytest.mark.parametrize("scorer", [BM25(), TFIDF()], ids=["bm25", "tfidf"])
def test_candidate_tiers_match_jax(cand_reader, knobs, jax_decode, scorer):
    """dslice, sort and join forced as ``tests/test_candidates.py`` forces
    them, on a reader with deletes."""
    knobs(**FORCED)
    segs = list(cand_reader.segments)
    tiers = Counter(check_single(f, segs, scorer, 10) for f in CAND_QUERIES)
    assert tiers == {"dslice": 1, "sort": 4, "join": 3}, tiers
    assert check_batch(CAND_QUERIES, segs, scorer, 10) == tiers
    # all matches: k past the match count
    assert check_single(F.Or(T("t00"), T("t03")), segs, scorer, 500) == "sort"


SORT_WAND_QUERIES = [
    F.Or(T("t00"), T("t01"), T("t07")),
    F.Or(T("t00"), T("t01"), T("t02"), min_match=2),
]


@pytest.mark.parametrize("mode", ["exact", "strict", "approx"])
def test_sort_tier_wand_matches_jax(cand_reader, knobs, jax_decode, mode):
    knobs(**FORCED)
    segs = list(cand_reader.segments)
    kw = dict(wand=True, wand_sample=2, wand_mode=mode)
    for f in SORT_WAND_QUERIES:
        tq = tex.DeviceQuery(f, segs, BM25(), device=CPU, **kw)
        assert tq.plan(0).groups[0].ub is not None
        assert check_single(f, segs, BM25(), 10, oracle=mode == "exact", **kw) == "sort"
    assert set(check_batch(SORT_WAND_QUERIES, segs, BM25(), 10, **kw)) == {"sort"}


@pytest.mark.parametrize("wand", [False, True], ids=["plain", "wand"])
def test_direct_tier_matches_jax(zipf_reader, knobs, jax_decode, wand):
    """A single sparse term longer than the dslice bound takes the direct
    tier (the bound is lowered to 8 blocks so 3000 docs reach it)."""
    knobs(DSLICE_PAD=8, USE_DENSE_TERMS=False)
    segs = list(zipf_reader.segments)
    kw = dict(wand=wand, wand_sample=4)
    queries = [T("w00"), T("w01"), T("w05")]
    for f in queries:
        assert check_single(f, segs, BM25(), 10, **kw) == "direct"
    assert set(check_batch(queries, segs, BM25(), 10, **kw)) == {"direct"}


def test_gridmix_and_grid_probe_join_match_jax(bench20k, jax_decode):
    """Dense-grid and sparse spans together at the default knobs: gridmix
    (Or of High and Low terms, min_match, prefix, fuzzy) and join with
    grid-probed spans (And of a High and a Low term)."""
    sr, c = bench20k
    h, m, lo = c["HighTerm"], c["MedTerm"], c["LowTerm"]
    queries = {
        "gridmix": [
            F.Or(h[0], lo[0]),
            F.Or(h[0], m[1], lo[2], min_match=2),
            F.ByPrefix("body", h[0].term.decode()[:4]),
            F.ByEditDistance("body", m[0].term.decode(), max_distance=1),
        ],
        "join": [F.And(h[0], lo[3]), F.And(m[2], F.Not(h[1])), F.And(lo[0], lo[1])],
        "sort": [F.Or(lo[0], lo[1])],
        "dslice": [lo[0]],
    }
    filters = []
    for tier, fl in queries.items():
        for f in fl:
            assert check_single(f, [sr], BM25(), 10) == tier
        filters += fl
    tiers = check_batch(filters, [sr], BM25(), 10, wand=True)
    assert set(tiers) == set(queries), tiers


def test_smoke_queries_match_jax(bench20k):
    """``chip_smoke.py``'s new phase at 20k docs: the breadth categories
    and a term of each mix category through the single-query executor, and
    one query per tier in one batch, each plan under its own planner knobs
    (``bench_mix.planner_knobs``), on both packages."""
    from iresearch_tpu.exec.batch import QueryBatch as JaxQueryBatch

    sr, c = bench20k
    single = Counter()
    for name, flt, wand in bench_mix.breadth_tasks(sr):
        if name != "Phrase":
            single[check_single(flt, [sr], BM25(), 10, wand=wand)] += 1
    for cat in ("HighTerm", "LowTerm"):
        single[check_single(c[cat][7], [sr], BM25(), 10, wand=True)] += 1
    # a lone grid term with WAND: no skyline at this size, no single-span scan
    assert single == {"scan": 4, "wand": 1, "dslice": 1, "join": 1, "sort": 1, "gridmix": 1}
    tt = bench_mix.tier_tasks(sr)
    filters = [f for _t, f, _k in tt]
    port = QueryBatch(filters, [sr], BM25(), wand=True, device=CPU)
    ref = JaxQueryBatch(filters, [sr], BM25(), wand=True)
    for tq, jq, (_tier, _f, knobs) in zip(port.queries, ref.queries, tt):
        with bench_mix.planner_knobs(**knobs):
            tq.plan(0), jq.plan(0)
    prep = port.prepare(0, 10)
    assert [call[0] for call in prep.calls] == [t for t, _f, _k in tt]
    for (gv, gd), (wv, wd), flt in zip(prep.run(), ref.prepare(0, 10).run(), filters):
        assert_topk_near((gv.numpy(), gd.numpy()), (wv, wd))
        assert_topk_near((gv.numpy(), gd.numpy()), _oracle(flt, [sr], BM25(), 10))


def test_legacy_segment_matches_jax(legacy_reader, knobs, jax_decode):
    """bn == -1: the freq pool stands in for the norm pool and dl is
    norms[docs], in the fold, WAND, dslice, sort and join tiers."""
    segs = list(legacy_reader.segments)
    fold = [F.Not(T("t02")), F.And(T("t00"), F.ByPhrase("body", ["t01", "t02"]))]
    assert {check_single(f, segs, BM25(), 10) for f in fold} == {"fold", "aux"}
    assert check_single(T("t00"), segs, BM25(), 10, wand=True, wand_sample=2) == "wand"
    knobs(**FORCED)
    tiers = Counter(check_single(f, segs, BM25(), 10) for f in CAND_QUERIES)
    assert tiers == {"dslice": 1, "sort": 4, "join": 3}, tiers
    assert check_batch(CAND_QUERIES + fold, segs, BM25(), 10, wand=True) == {
        "dslice": 1, "sort": 4, "join": 3, "fold": 1, "aux": 1,
    }


# --- global entry points ------------------------------------------------------


@pytest.fixture(scope="module")
def two_segment_reader():
    """Two segments with deletes (``tests/test_device_exec.py``'s shape)."""
    words = ["alpha", "beta", "gamma", "delta", "epsilon", "zeta", "eta", "theta"]
    rng = np.random.default_rng(7)
    d = MemoryDirectory()
    with IndexWriter(d, IndexWriterOptions(invert_backend="numpy")) as w:
        for i in range(300):
            n = int(rng.integers(2, 30))
            idx = np.minimum(rng.zipf(1.4, size=n) - 1, len(words) - 1)
            w.insert([
                Field("body", " ".join(words[j] for j in idx), analyzer="segmentation"),
                Field("id", str(i), index=True, store=True),
            ])
            if i == 150:
                w.commit()
        w.commit()
        w.remove(F.ByTerm("id", "42"))
        w.remove(F.ByTerm("id", "217"))
        w.commit()
    r = DirectoryReader.open(d)
    assert len(r.segments) == 2
    return r


GLOBAL_QUERIES = [
    F.Or(F.ByTerm("body", "alpha"), F.ByTerm("body", "gamma")),
    F.And(F.ByTerm("body", "alpha"), F.Not(F.ByTerm("body", "beta"))),
    F.ByPrefix("body", "e"),
]


def _near_lists(got, want):
    assert_topk_near(
        (np.asarray([s for _d, s in got], np.float32), np.asarray([d for d, _s in got])),
        (np.asarray([s for _d, s in want], np.float32), np.asarray([d for d, _s in want])),
    )


def test_search_device_matches_jax(two_segment_reader):
    from iresearch_tpu.exec import search_device as jax_search_device

    for flt in GLOBAL_QUERIES:
        got = tex.search_device(two_segment_reader, flt, BM25(), k=10, device=CPU)
        want = jax_search_device(two_segment_reader, flt, BM25(), k=10)
        _near_lists(got, want)
        assert got == sorted(got, key=lambda t: (-t[1], t[0]))


def test_query_batch_search_matches_jax(two_segment_reader):
    from iresearch_tpu.exec.batch import QueryBatch as JaxQueryBatch

    segs = list(two_segment_reader.segments)
    got = QueryBatch(GLOBAL_QUERIES, segs, BM25(), device=CPU).search(10)
    want = JaxQueryBatch(GLOBAL_QUERIES, segs, BM25()).search(10)
    for g, w in zip(got, want):
        _near_lists(g, w)
    per_seg = QueryBatch(GLOBAL_QUERIES, segs, BM25(), device=CPU).execute_segment(1, 10)
    assert all(isinstance(v, np.ndarray) and v.shape == (10,) for v, _d in per_seg)


def test_device_phrase_default_raises(cand_reader):
    """The JAX default device_phrase=True runs phrases on the device, which
    is not ported yet (ROADMAP queue 1 item 11)."""
    segs = list(cand_reader.segments)
    flt = F.And(T("t00"), F.ByPhrase("body", ["t01", "t02"]))
    with pytest.raises(NotImplementedError, match="item 11"):
        tex.DeviceQuery(flt, segs, BM25(), device=CPU).execute_segment(0, 10)


def test_device_aux_plan_raises(cand_reader):
    """A plan with an on-device phrase (compiled by the JAX package) has
    no tier in the port yet."""
    from iresearch_tpu.exec import DeviceQuery as JaxDeviceQuery

    segs = list(cand_reader.segments)
    flt = F.ByPhrase("body", ["t00", "t01"])
    plan = JaxDeviceQuery(flt, segs, BM25()).plan(0)
    assert plan.device_aux
    with pytest.raises(NotImplementedError, match="device_aux"):
        group_call(
            segs[0], [plan], 10, BM25(), CPU, sky_specs=[None], sky_M=None,
            wand_sample=16, wand_mode="exact", single=True,
        )


def test_prepare_all_raises(two_segment_reader):
    """The merge across segments on the device is not ported yet (ROADMAP
    queue 1 item 12); ``search`` merges on the host."""
    qb = QueryBatch(GLOBAL_QUERIES, list(two_segment_reader.segments), BM25(), device=CPU)
    with pytest.raises(NotImplementedError, match="item 12"):
        qb.prepare_all(10)


def test_device_query_needs_a_device(cand_reader):
    with pytest.raises(TypeError):
        tex.DeviceQuery(T("t00"), list(cand_reader.segments), BM25())
    with pytest.raises(ValueError):
        tex.DeviceQuery(T("t00"), list(cand_reader.segments), BM25(),
                        wand_mode="fuzzy", device=CPU)


# --- bodies on the JAX package's own device inputs ----------------------------


def _t(a):
    a = np.array(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


def _j(t):
    return jnp.asarray(t.numpy())


class Inputs:
    """One plan's device inputs as the JAX DeviceQuery builds them, and
    the same arrays as torch tensors with a query axis of 1."""

    def __init__(self, flt, segs, scorer=BM25(), **kw):
        from iresearch_tpu.exec import DeviceQuery as JaxDeviceQuery

        self.scorer = scorer
        self.jq = JaxDeviceQuery(flt, segs, scorer, device_phrase=False, **kw)
        self.plan = self.jq.plan(0)
        (self.jpools, self.jrows, self.gbits, self.jam, self.jas, self.jalive,
         self.javgdl, self.jleafmin, self.jdargs, self.dstat) = self.jq._device_inputs(self.plan)
        self.pools = tuple(tuple(_t(x) for x in p) for p in self.jpools)
        self.rows = tuple(tuple(_t(x)[None] for x in rs) for rs in self.jrows)
        self.avgdl = _t(self.javgdl)
        self.leafmin = _t(self.jleafmin)[None]
        self.alive = _t(self.jalive)
        self.dargs = tuple(
            (_t(d[0]), _t(d[1]).reshape(1), _t(d[2]).reshape(1), _t(d[3]), _t(d[4]))
            + ((_t(d[5])[None], _t(d[6]).reshape(1)) if len(d) > 5 else ())
            for d in self.jdargs
        )
        p = self.plan
        self.kw = dict(tree=p.tree, gbits=self.gbits, scorer=scorer, num_leaves=p.num_leaves)
        self.nreal = np.asarray([g.real_rows * 128 for g in p.groups], np.int32)


def _same_topk(got, want):
    v, d = got
    assert_topk_near((v[0].numpy(), d[0].numpy()), (np.asarray(want[0]), np.asarray(want[1])))


def _body_fold_tree(r):
    rng = np.random.default_rng(5)
    lm = rng.random((3, 300)) < 0.5
    ls = rng.uniform(0.1, 4.0, (3, 300)).astype(np.float32) * lm
    am = rng.random((2, 300)) < 0.3
    as_ = rng.uniform(0.1, 2.0, (2, 300)).astype(np.float32) * am
    leaf = lambda i: ("leaf", i)  # noqa: E731
    trees = [
        ("empty",), ("all",), leaf(1), ("aux", 1), ("not", leaf(0)),
        ("and", (leaf(0), leaf(1), ("aux", 0)), (leaf(2),), "sum"),
        ("and", (leaf(0), leaf(2)), (), "min"),
        ("or", (leaf(0), leaf(1), leaf(2)), (), 2, "max"),
        ("or", (leaf(0), ("aux", 1)), (("aux", 0),), 0, "sum"),
        ("or", (("and", (leaf(0), leaf(1)), (), "max"), ("not", leaf(2))), (), 1, "sum"),
    ]
    for tree in trees:
        wm, ws = jex._fold_tree(tree, jnp.asarray(lm), jnp.asarray(ls), jnp.asarray(am),
                                jnp.asarray(as_), 300, jnp)
        gm, gs = tex.fold_tree(tree, *(torch.from_numpy(a)[None] for a in (lm, ls, am, as_)))
        np.testing.assert_array_equal(gm[0].numpy(), np.asarray(wm), err_msg=str(tree))
        np.testing.assert_array_equal(gs[0].numpy(), np.asarray(ws), err_msg=str(tree))


def _body_group_contrib(r):
    for gi, (pool, rs) in enumerate(zip(r.jpools, r.jrows)):
        bd, bf, bn = r.gbits[gi]
        wd, ws, wm, wdl = jex._group_contrib(pool, *rs[:4], bd, bf, bn, r.javgdl[gi],
                                             r.scorer, want_dl=True)
        gd, gs, gm, gdl = tex.group_contrib(r.pools[gi], *r.rows[gi][:4], r.gbits[gi],
                                            r.avgdl[gi], r.scorer, want_dl=True)
        np.testing.assert_array_equal(gd[0].numpy(), np.asarray(wd))
        np.testing.assert_array_equal(gm[0].numpy(), np.asarray(wm))
        np.testing.assert_array_equal(gdl[0].numpy(), np.broadcast_to(np.asarray(wdl), gdl[0].shape))
        np.testing.assert_allclose(gs[0].numpy(), np.asarray(ws), rtol=1e-6, atol=0.0)


def _body_dense_contrib(r):
    nd = r.plan.nd_pad
    assert r.jdargs
    for jd, pd, st in zip(r.jdargs, r.dargs, r.dstat):
        keep_np = np.arange(st[2]) % 3 != 0
        for keep in (None, keep_np):
            ws, wm = jex._dense_contrib(jd, st, r.scorer, nd, jnp,
                                        keep=None if keep is None else jnp.asarray(keep))
            gs, gm = tex.dense_contrib(pd, st, r.scorer,
                                       keep=None if keep is None else torch.from_numpy(keep)[None])
            np.testing.assert_array_equal(gm[0].numpy(), np.asarray(wm))
            np.testing.assert_allclose(gs[0].numpy(), np.asarray(ws), rtol=1e-6, atol=0.0)


def _body_segment_body(r):
    nd = r.plan.nd_pad
    am = asc = None
    tam = tas = None
    if r.jam is not None:
        am, asc = r.jam, r.jas
        tam, tas = _t(am)[None], _t(asc)[None]
    wm, ws = jex.segment_body(
        r.jpools, r.jrows, r.javgdl, r.jleafmin, am, asc, r.jalive, nd=nd,
        dense_args=r.jdargs, dense_static=r.dstat, **r.kw,
    )
    gm, gs = tex.segment_body(
        r.pools, r.rows, r.avgdl, r.leafmin, tam, tas, r.alive, nd=nd,
        dense_args=r.dargs, dense_static=r.dstat, **r.kw,
    )
    np.testing.assert_array_equal(gm[0].numpy(), np.asarray(wm))
    np.testing.assert_allclose(gs[0].numpy(), np.asarray(ws), rtol=1e-5, atol=1e-6)


def _body_wand_body(r):
    nd = r.plan.nd_pad
    for mode in ("exact", "strict", "approx"):
        want = jex.wand_body(r.jpools, r.jrows, r.javgdl, r.jleafmin, r.jalive, k=10,
                             nd=nd, sample=2, mode=mode, dense_args=r.jdargs,
                             dense_static=r.dstat, **r.kw)
        got = tex.wand_body(r.pools, r.rows, r.avgdl, r.leafmin, r.alive, k=10, nd=nd,
                            sample=2, mode=mode, dense_args=r.dargs,
                            dense_static=r.dstat, **r.kw)
        _same_topk(got, want)


def _body_decode_flat(r):
    from iresearch_tpu.exec import candidates as jc

    want = jc.decode_flat(r.jpools, r.jrows, r.javgdl, r.gbits, r.scorer)
    got = tc.decode_flat(r.pools, r.rows, r.avgdl, r.gbits, r.scorer, decode=tex.decode_rows)
    for g, w in zip(got, want):
        if g.dtype == torch.float32:
            np.testing.assert_allclose(g[0].numpy(), np.asarray(w), rtol=1e-6, atol=0.0)
        else:
            np.testing.assert_array_equal(g[0].numpy(), np.asarray(w))


def _body_direct_topk(r):
    from iresearch_tpu.exec import candidates as jc

    for k in (1, 10, 300):
        want = jc.direct_topk(r.jpools, r.jrows, r.javgdl, r.jalive, gbits=r.gbits,
                              scorer=r.scorer, k=k)
        got = tc.direct_topk(r.pools, r.rows, r.avgdl, r.alive, gbits=r.gbits,
                             scorer=r.scorer, k=k, decode=tex.decode_rows)
        _same_topk(got, want)


def _body_sorted_topk(r):
    from iresearch_tpu.exec import candidates as jc

    for k in (1, 10):
        want = jc.sorted_topk(r.jpools, r.jrows, r.javgdl, r.jleafmin, r.jalive, k=k, **r.kw)
        got = tc.sorted_topk(r.pools, r.rows, r.avgdl, r.leafmin, r.alive, k=k,
                             decode=tex.decode_rows, **r.kw)
        _same_topk(got, want)


def _body_dense_probe(r):
    from iresearch_tpu.exec import candidates as jc

    assert r.jdargs
    rng = np.random.default_rng(9)
    nd = r.plan.nd_pad
    cdocs = np.concatenate([rng.integers(0, nd, 500), [-1, nd, nd + 5, 2**31 - 1]]).astype(np.int32)
    dl = rng.uniform(1, 60, cdocs.shape).astype(np.float32)
    for jd, pd, st in zip(r.jdargs, r.dargs, r.dstat):
        for use_dl in (False, True):
            ws, wh = jc.dense_probe(jd, st, jnp.asarray(cdocs), r.scorer, jnp,
                                    dl=jnp.asarray(dl) if use_dl else None)
            gs, gh = tc.dense_probe(pd, st, torch.from_numpy(cdocs)[None], r.scorer,
                                    dl=torch.from_numpy(dl)[None] if use_dl else None)
            np.testing.assert_array_equal(gh[0].numpy(), np.asarray(wh))
            np.testing.assert_allclose(gs[0].numpy(), np.asarray(ws), rtol=1e-6, atol=0.0)


def _body_join_topk(r):
    from iresearch_tpu.exec import candidates as jc

    p = r.plan
    assert p.exec_mode == "join"
    gl = tuple(int(g.leaf[0]) for g in p.groups)
    for k in (1, 10):
        want = jc.join_topk(r.jpools, r.jrows, r.javgdl, r.jleafmin, r.jalive,
                            jnp.asarray(r.nreal), k=k, driver_gi=p.driver_gi,
                            group_leaf=gl, dense_args=r.jdargs, dense_static=r.dstat, **r.kw)
        got = tc.join_topk(r.pools, r.rows, r.avgdl, r.leafmin, r.alive,
                           torch.from_numpy(r.nreal)[None], k=k, driver_gi=p.driver_gi,
                           group_leaf=gl, decode=tex.decode_rows, dense_args=r.dargs,
                           dense_static=r.dstat, **r.kw)
        _same_topk(got, want)


def _body_merge_topk_lists(r):
    from iresearch_tpu.exec import candidates as jc

    rng = np.random.default_rng(11)
    for _ in range(5):
        va = np.sort(rng.integers(1, 6, 10).astype(np.float32))[::-1].copy()
        vb = np.sort(rng.integers(1, 6, 8).astype(np.float32))[::-1].copy()
        vb[-2:] = -np.inf
        da = rng.choice(40, 10, replace=False).astype(np.int32)
        db = rng.choice(40, 8, replace=False).astype(np.int32)
        want = jc.merge_topk_lists(*map(jnp.asarray, (va, da, vb, db)), 10)
        got = tc.merge_topk_lists(*(torch.from_numpy(a)[None] for a in (va, da, vb, db)), 10)
        _same_topk(got, want)


def _body_gridmix_topk(r):
    from iresearch_tpu.exec import candidates as jc

    p = r.plan
    assert p.exec_mode == "gridmix"
    for k in (1, 10):
        want = jc.gridmix_topk(r.jpools, r.jrows, r.javgdl, r.jleafmin, None, k=k,
                               nd=p.nd_pad, dense_args=r.jdargs, dense_static=r.dstat, **r.kw)
        got = tc.gridmix_topk(r.pools, r.rows, r.avgdl, r.leafmin, None, k=k,
                              nd=p.nd_pad, decode=tex.decode_rows, dense_args=r.dargs,
                              dense_static=r.dstat, **r.kw)
        _same_topk(got, want)


def _body_wand_theta(r):
    from iresearch_tpu.exec import candidates as jc

    order = [np.argsort(-np.asarray(rs[5]), kind="stable") for rs in r.jrows]
    jsorted = [tuple(x[o] for x in rs) for rs, o in zip(r.jrows, order)]
    tsorted = [tex.sort_by_ub(rs) for rs in r.rows]
    for a, b in zip(jsorted, tsorted):
        np.testing.assert_array_equal(b[0][0].numpy(), np.asarray(a[0]))
    for mode in ("direct", "sort"):
        for wand_mode in ("exact", "strict"):
            want = jc.wand_theta(r.jpools, jsorted, r.javgdl, r.jleafmin, None, k=5,
                                 sample=2, mode=mode, wand_mode=wand_mode, **r.kw)
            got = tc.wand_theta(r.pools, tsorted, r.avgdl, r.leafmin, None, k=5,
                                sample=2, mode=mode, decode=tex.decode_rows,
                                wand_mode=wand_mode, **r.kw)
            np.testing.assert_allclose(got.numpy(), np.asarray(want)[None], rtol=1e-5)


def _body_candidate_body(r):
    from iresearch_tpu.exec import candidates as jc

    for mode in ("direct", "sort"):
        for wand_mode in ("exact", "strict", "approx"):
            kw = dict(k=10, mode=mode, wand=True, sample=2, wand_mode=wand_mode, **r.kw)
            want = jc.candidate_body(r.jpools, r.jrows, r.javgdl, r.jleafmin, r.jalive, **kw)
            got = tc.candidate_body(r.pools, r.rows, r.avgdl, r.leafmin, r.alive,
                                    decode=tex.decode_rows, **kw)
            _same_topk(got, want)


def _body_dslice_topk(r):
    from iresearch_tpu.exec import candidates as jc

    p = r.plan
    assert p.exec_mode == "dslice"
    R, starts = jex.dslice_shape(p, r.jpools[0])
    g = p.groups[0]
    want = jc.dslice_topk(r.jpools[0], jnp.asarray(starts), jnp.int32(g.real_rows),
                          jnp.float32(g.weight[0]), r.javgdl[0], r.jalive,
                          gbits=r.gbits[0], scorer=r.scorer, k=10, R=R)
    sr = r.jq.prepared.segments[0]
    tier, fn, args, kwargs = group_call(sr, [p], 10, r.scorer, CPU, sky_specs=[None],
                                        sky_M=None, wand_sample=16, wand_mode="exact",
                                        single=True)
    assert tier == "dslice" and kwargs["R"] == R
    _same_topk(fn(tex.PLAIN, *args, **kwargs), want)


# body -> (reader fixture, filter, planner knobs, DeviceQuery kwargs)
BODIES = {
    "fold_tree": (_body_fold_tree, "cand_reader", T("t00"), {}, {}),
    "group_contrib": (_body_group_contrib, "cand_reader", F.Or(T("t00"), T("t03"), min_match=2), FORCED, {}),
    "group_contrib_legacy": (_body_group_contrib, "legacy_reader", F.Or(T("t00"), T("t03"), min_match=2), FORCED, {}),
    "dense_contrib": (_body_dense_contrib, "zipf_reader", F.Or(T("w00"), T("w04")), {}, {}),
    "segment_body": (_body_segment_body, "cand_reader",
                     F.And(T("t00"), F.ByPhrase("body", ["t01", "t02"]), F.Not(T("t04"))), FORCED, {}),
    "segment_body_dense": (_body_segment_body, "zipf_reader", F.Or(T("w00"), T("w03"), merge="max"), {}, {}),
    "wand_body": (_body_wand_body, "cand_reader", F.Or(T("t00"), T("t01"), T("t07")),
                  dict(JOIN_MAX_SPANS=0, USE_DENSE_TERMS=False), dict(wand=True)),
    "wand_body_dense": (_body_wand_body, "zipf_reader", F.Or(T("w00"), T("w01"), T("w02"), min_match=2),
                        dict(JOIN_MAX_SPANS=0), dict(wand=True)),
    "decode_flat": (_body_decode_flat, "cand_reader", F.Or(T("t00"), T("t05")), FORCED, {}),
    "direct_topk": (_body_direct_topk, "cand_reader", T("t01"), FORCED, {}),
    "sorted_topk": (_body_sorted_topk, "cand_reader",
                    F.And(F.Or(T("t00"), T("t04")), F.Or(T("t02"), T("t06"))), FORCED, {}),
    "dense_probe": (_body_dense_probe, "bench20k", None, {}, {}),
    "join_topk": (_body_join_topk, "cand_reader", F.And(F.Or(T("t01"), T("t06")), T("t03")), FORCED, {}),
    "join_topk_grid_probe": (_body_join_topk, "bench20k", None, {}, {}),
    "merge_topk_lists": (_body_merge_topk_lists, "cand_reader", T("t00"), {}, {}),
    "gridmix_topk": (_body_gridmix_topk, "bench20k", None, {}, {}),
    "wand_theta": (_body_wand_theta, "cand_reader", F.Or(T("t00"), T("t01"), T("t07")), FORCED, dict(wand=True)),
    "candidate_body": (_body_candidate_body, "cand_reader", F.Or(T("t00"), T("t01"), T("t07")), FORCED, dict(wand=True)),
    "dslice_topk": (_body_dslice_topk, "cand_reader", T("t03"), FORCED, {}),
}


def _bench_filter(name, cats):
    h, lo = cats["HighTerm"], cats["LowTerm"]
    if name in ("dense_probe", "join_topk_grid_probe"):
        return F.And(h[0], lo[3])
    return F.Or(h[0], lo[0])


@pytest.mark.parametrize("name", sorted(BODIES))
def test_body_matches_jax(request, knobs, name):
    """Each body of the slice on the JAX DeviceQuery's own device inputs,
    the JAX side decoding through XLA (the tier tests above also run its
    Pallas decode)."""
    body, reader_name, flt, plan_knobs, dq_kw = BODIES[name]
    reader = request.getfixturevalue(reader_name)
    if reader_name == "bench20k":
        sr, cats = reader
        segs, flt = [sr], _bench_filter(name, cats)
    else:
        segs = list(reader.segments)
    knobs(**plan_knobs)
    body(Inputs(flt, segs, **dq_kw))
