"""The port's segment-sharded execution (``parallel/sharded.py``,
``parallel/dense_stack.py``) vs the JAX package's ``ShardedSearcher`` on the
CPU.

Two indexes (and a few small ones of single tests), written by the JAX
package and carried to the port through the segment file (``carried``);
filters and scorers go through ``to_port``:

* ``tests/test_sharded.py``'s reader: 400 docs in seven segments, one doc
  deleted;
* four 16,384-doc segments from ``tests/test_sharded_scale.py``'s
  ``_build_segment``, large enough for the uniform dense layout, the dense
  fold, gridmix and WAND.

The JAX searcher runs on ``conftest.py``'s 8 virtual CPU devices (fewer
where a test says why), so its ``S`` pads to 8; the port's one process holds every segment (``S`` = the
segment count, ``per_shard`` = ``S``). The results are held against each
other with the exactness gate (``assert_topk_near``: scores rtol 1e-5, docs
equal except inside near-ties; XLA on the CPU rounds some lanes of the same
score one ulp apart) and against the port's ``HostQuery``; the grouping and
tier per query, the uniform dense layout and the phrase-keys form against
the JAX package's.
"""

import dataclasses
import os
import pickle
import socket
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from iresearch_tpu.index.reader import DirectoryReader  # noqa: E402
from iresearch_tpu.index.writer import Field, IndexWriter, IndexWriterOptions  # noqa: E402
from iresearch_tpu.search import filters as F  # noqa: E402
from iresearch_tpu.search.scorers import BM25, TFIDF  # noqa: E402
from iresearch_tpu.store.directory import MemoryDirectory  # noqa: E402
from iresearch_tpu_torch.exec.phrase import PhraseKeysSpec  # noqa: E402
from iresearch_tpu_torch.parallel import ShardedSearcher, make_mesh  # noqa: E402
from iresearch_tpu_torch.search.host_eval import HostQuery  # noqa: E402
from test_torch_carry import _same, carried, carry, to_port  # noqa: E402
from test_torch_exec import assert_topk_near  # noqa: E402
from topk_util import assert_topk_equiv  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORDS = [
    "ant", "bee", "cat", "dog", "elk", "fox", "gnu", "hen", "ibis", "jay",
    "kite", "lark", "mole", "newt", "owl", "pig", "quail", "rat", "seal", "toad",
]
QUERIES = [
    F.ByTerm("body", "fox"),
    F.ByTerm("body", "toad"),
    F.Or(F.ByTerm("body", "fox"), F.ByTerm("body", "dog")),
    F.And(F.ByTerm("body", "ant"), F.ByTerm("body", "bee")),
    F.Or(F.ByTerm("body", "ant"), F.ByTerm("body", "bee"), F.ByTerm("body", "cat"), min_match=2),
    F.ByPrefix("body", "s"),
    F.And(F.ByTerm("body", "ant"), F.Not(F.ByTerm("body", "cat"))),
    F.ByPhrase("body", ["ant", "bee"]),
]
# ``test_batched_wand_sharded``'s list
WAND_QUERIES = QUERIES + [
    F.Or(*[F.ByTerm("body", w) for w in ("fox", "dog", "owl", "rat")]),
    F.ByTerm("body", "quail"),
]
SCALE_QUERIES = [
    F.ByTerm("body", "t00000"),  # hottest: dense
    F.ByTerm("body", "t05000"),  # mid: sparse tiers
    F.Or(F.ByTerm("body", "t00001"), F.ByTerm("body", "t00002")),
    F.Or(F.ByTerm("body", "t00000"), F.ByTerm("body", "t09000")),
    F.Or(F.ByTerm("body", "t00000"), F.ByTerm("body", "t00300")),  # gridmix
    F.And(F.ByTerm("body", "t00000"), F.ByTerm("body", "t06000")),
    F.ByPrefix("body", "t001", scored_terms_limit=16),
    F.ByPhrase("body", ["t00000", "t00001"]),
    F.And(F.ByTerm("body", "t00003"), F.ByPhrase("body", ["t00000", (2, "t00002")])),
]


@pytest.fixture(scope="module")
def segs():
    """``tests/test_sharded.py``'s reader (seven segments, doc 13 deleted)."""
    rng = np.random.default_rng(11)
    d = MemoryDirectory()
    with IndexWriter(d, IndexWriterOptions(invert_backend="numpy")) as w:
        for i in range(400):
            n = int(rng.integers(2, 20))
            idx = np.minimum(rng.zipf(1.5, size=n) - 1, len(WORDS) - 1)
            w.insert([
                Field("body", " ".join(WORDS[j] for j in idx), analyzer="segmentation"),
                Field("id", str(i), index=True, store=True),
            ])
            if i % 65 == 64:
                w.commit()
        w.commit()
        w.remove(F.ByTerm("id", "13"))
        w.commit()
    return carried(DirectoryReader.open(d))


@pytest.fixture(scope="module")
def scale():
    """Four 16,384-doc segments of ``tests/test_sharded_scale.py``."""
    from test_sharded_scale import _build_segment

    jsegs = [_build_segment(100 + i, 16_384) for i in range(4)]
    return jsegs, [carry(sr) for sr in jsegs]


@pytest.fixture(scope="module")
def searchers(segs):
    from iresearch_tpu.parallel import ShardedSearcher as JaxSearcher
    from iresearch_tpu.parallel import make_mesh as jax_mesh

    return JaxSearcher(segs.jax, jax_mesh()), ShardedSearcher(segs.port, device="cpu")


@pytest.fixture(scope="module")
def scale_searchers(scale):
    """The JAX searcher on four of the eight devices: its uniform dense
    pools stack the real segments only, so ``S`` must not pad."""
    import jax

    from iresearch_tpu.parallel import ShardedSearcher as JaxSearcher
    from iresearch_tpu.parallel import make_mesh as jax_mesh

    jsegs, psegs = scale
    return (JaxSearcher(jsegs, jax_mesh(jax.devices()[:4])),
            ShardedSearcher(psegs, device="cpu"))


def _groups(jprep, pprep):
    """(JAX, port) per signature group: query indices, mode, WAND."""
    want = [(list(q), st["mode"], st["use_wand"]) for q, _a, st, _l in jprep._calls]
    got = [(list(q), m, w) for q, m, w, _cap in pprep.groups]
    return want, got


_JAX_RUNS = {}


def _jax_run(js, filters, scorer, wand, k):
    """(prepared batch, per-query (vals, docs) numpy) of the JAX searcher
    ``js``, kept per searcher and inputs: a later test of the same inputs
    reuses them instead of compiling again (the entry keeps ``js`` alive,
    so no other searcher takes its ``id``)."""
    key = (id(js), tuple(filters), scorer, wand, k)
    if key not in _JAX_RUNS:
        jprep = js.prepare_many(filters, scorer, wand=wand)
        _JAX_RUNS[key] = (js, jprep, [(np.asarray(v), np.asarray(d)) for v, d in jprep.run(k)])
    return _JAX_RUNS[key][1:]


def _hold(filters, searchers, port_segs, scorer, wand, k=10):
    """One ``prepare_many`` in each package over ``filters``: the same
    groups and tiers, every query's top-k through the gate against the JAX
    result and against the port's ``HostQuery`` over all segments; returns
    both prepared batches, the JAX package's first."""
    js, ps = searchers
    jprep, jrun = _jax_run(js, filters, scorer, wand, k)
    pprep = ps.prepare_many([to_port(f) for f in filters], to_port(scorer), wand=wand)
    want, got = _groups(jprep, pprep)
    assert got == want
    assert pprep._kmax == jprep._kmax
    for flt, (jv, jd), (pv, pd) in zip(filters, jrun, pprep.run(k)):
        assert_topk_near((pv.numpy(), pd.numpy()), (np.asarray(jv), np.asarray(jd)))
        hits = [(int(d), float(v)) for v, d in zip(pv.numpy(), pd.numpy()) if np.isfinite(v)]
        assert_topk_equiv(hits, HostQuery(to_port(flt), port_segs, to_port(scorer)).top_k(k))
    return jprep, pprep


def test_searcher_shape(searchers, segs):
    """S, per_shard, nd_pad and the doc bases as the JAX package computes
    them for one device per segment group: one process holds all seven."""
    js, ps = searchers
    assert (ps.D, ps.S, ps.per_shard) == (1, 7, 7) and ps.per_shard >= 2
    assert (js.D, js.S, js.per_shard) == (8, 8, 1)
    assert ps.nd_pad == js.nd_pad == 128
    assert ps.total_docs == js.total_docs == 400
    np.testing.assert_array_equal(ps._doc_base, js._doc_base[: ps.S])
    assert ps.local == list(range(7))
    assert make_mesh(["cpu"]) == (None, 0, 1, (torch.device("cpu"),)) == ps.mesh
    assert ps.shards == [(0, torch.device("cpu"), list(range(7)))]


@pytest.mark.parametrize("scorer", [BM25(), TFIDF()], ids=["bm25", "tfidf"])
def test_prepare_many_matches_jax(searchers, segs, scorer):
    """``QUERIES`` through one ``prepare_many`` each, without WAND."""
    _jprep, pprep = _hold(QUERIES, searchers, segs.port, scorer, False)
    assert {m for _q, m, _w, _c in pprep.groups} >= {"direct", "sort", "dense"}


def test_wand_matches_jax(searchers, segs):
    """``test_batched_wand_sharded``'s list with WAND; a second run gives
    the same results."""
    _jprep, pprep = _hold(WAND_QUERIES, searchers, segs.port, BM25(), True)
    a, b = pprep.top_k(10), pprep.top_k(10)
    assert a == b


def test_prepare_and_search_match_jax(searchers, segs):
    """``prepare`` (Q = 1) and ``search`` against the JAX package's."""
    js, ps = searchers
    flt = F.Or(F.ByTerm("body", "fox"), F.ByTerm("body", "hen"))
    pq = ps.prepare(to_port(flt), to_port(BM25()))
    assert pq.top_k(10) == pq.top_k(10)
    assert_topk_near([x.numpy() for x in pq.run(10)],
                     [np.asarray(x) for x in js.prepare(flt, BM25()).run(10)])
    got = ps.search(to_port(flt), to_port(BM25()), k=10)
    assert_topk_equiv(got, js.search(flt, BM25(), k=10))
    assert all(isinstance(d, int) for d, _s in got) and len(got) == 10


def test_scale_matches_jax(scale_searchers, scale):
    """The 4 x 16,384-doc index with WAND, as ``test_sharded_scale``: the
    dense fold under WAND, gridmix, the direct tier and phrase keys."""
    _js, ps = scale_searchers
    assert ps._dense_layout("body").terms
    _jprep, pprep = _hold(SCALE_QUERIES, scale_searchers, scale[1], BM25(), True)
    tiers = {c[0] for c in pprep.calls}
    assert {"wand", "aux", "gridmix", "direct"} <= tiers, tiers


def test_uniform_layout_matches_jax(scale_searchers, searchers):
    """``UniformDenseLayout`` equals the JAX package's field by field, its
    pools and bounds byte for byte, and so does every shard's view."""
    for js, ps in (scale_searchers, searchers):
        jl, pl = js._dense_layout("body"), ps._dense_layout("body")
        for name in ("fname", "terms", "stride", "cls", "start", "rows_c", "pools_np", "bmaxf_np"):
            _same(getattr(pl, name), getattr(jl, name), name)
        for si in range(len(ps.segments)):
            jc, pc = jl.shard_cache(si), pl.shard_cache(si)
            for f in dataclasses.fields(jc):
                _same(getattr(pc, f.name), getattr(jc, f.name), f"shard {si}.{f.name}")
    assert scale_searchers[1]._dense_layout("body").terms


def test_scored_only_kmax_enforced(scale_searchers, scale):
    """A scored-only prefix plan bounds k: ``run(k > kmax)`` raises, as in
    the JAX package."""
    js, ps = scale_searchers
    flt = F.ByPrefix("body", "t0000", scored_terms_limit=1)
    jprep = js.prepare_many([flt], BM25(), k_max=16)
    pprep = ps.prepare_many([to_port(flt)], to_port(BM25()), k_max=16)
    assert pprep._kmax == jprep._kmax and pprep._kmax is not None
    with pytest.raises(ValueError, match="re-prepare"):
        pprep.run(pprep._kmax + 1)
    assert_topk_near([x.numpy() for x in pprep.run(10)[0]], [np.asarray(x) for x in jprep.run(10)[0]])


def _keys_form(prep):
    """Per group, whether its phrase leaves run in the keys form."""
    return [any(kw.get("phrase_keys") is not None for t, q, _f, _a, kw in prep.calls if q == qis)
            for qis, *_r in prep.groups]


def test_phrase_keys_form(searchers, segs):
    """Phrases plan in the keys form (``PhraseKeysSpec`` rows, closing the
    single-segment runner's ``TypeError``) and run on the device: equal to
    the JAX package's keys form and to ``HostQuery``."""
    from iresearch_tpu_torch.exec.plan import PlanCompiler

    _js, ps = searchers
    phrases = [
        F.ByPhrase("body", ["ant", "bee"]),
        F.ByPhrase("body", ["ant", (2, "bee"), "cat"]),
        F.Or(F.ByTerm("body", "owl"), F.ByPhrase("body", ["fox", "ant"])),
        F.BySamePosition([("body", "ant"), ("body", "ant")]),
    ]
    jprep, pprep = _hold(phrases, searchers, segs.port, BM25(), False)
    assert all(_keys_form(pprep))
    assert all(st["phrase_static"] for _q, _a, st, _l in jprep._calls)
    for flt in phrases:
        pf, sc = to_port(flt), to_port(BM25())
        comp = PlanCompiler(HostQuery(pf, ps._wrapped_segments(), sc), sc)
        plan = comp.compile(pf, 0, device_phrase="keys")
        assert plan.device_aux and isinstance(plan.device_aux[0][1], PhraseKeysSpec)


def _segment(seed, n_docs, *, positions=True, pos_scale=1, vocab=50, field="body"):
    """A small JAX segment of ``n_docs`` Zipf docs in ``field``
    (``test_sharded_scale``'s law); without positions, or with every
    position times ``pos_scale``."""
    from iresearch_tpu.formats.postings import encode_field_postings
    from iresearch_tpu.formats.spec import IndexFeatures
    from iresearch_tpu.index.invert import invert_numpy
    from iresearch_tpu.index.segment import SegmentData, SegmentReader

    rng = np.random.default_rng(seed)
    lens = rng.integers(4, 12, size=n_docs)
    total = int(lens.sum())
    tids = np.minimum(rng.zipf(1.3, size=total) - 1, vocab - 1).astype(np.int64)
    doc = np.repeat(np.arange(n_docs), lens)
    starts = np.cumsum(lens) - lens
    pos = ((np.arange(total, dtype=np.int64) - np.repeat(starts, lens)) * pos_scale).astype(np.uint32)
    inv = invert_numpy(tids, doc, pos, vocab, n_docs)
    present = np.flatnonzero(np.diff(inv.term_ptr) > 0)
    terms = [b"t%05d" % t for t in present]
    offs = np.zeros(len(terms) + 1, np.uint64)
    offs[1:] = np.cumsum([len(t) for t in terms])
    tp = np.concatenate([inv.term_ptr[present], [inv.term_ptr[-1]]])
    feats = IndexFeatures.FREQ | (IndexFeatures.POS if positions else 0)
    fp = encode_field_postings(
        inv.e_doc, inv.e_freq, tp, b"".join(terms), offs, inv.norms,
        inv.pos_flat if positions else None, feats,
    )
    return SegmentReader(f"k{seed}", SegmentData(n_docs, {field: fp}, {}))


@pytest.mark.parametrize("fall", ["structure", "caplog"])
def test_phrase_keys_falls_to_host_aux(fall):
    """The keys form's two falls to host aux: a segment whose field has no
    positions gives the query a shard-variant structure, and positions so
    large that ``nd_pad << caplog`` reaches 2^31 leave no i32 key room.
    Both packages fall alike and give the same results."""
    import jax

    from iresearch_tpu.parallel import ShardedSearcher as JaxSearcher
    from iresearch_tpu.parallel import make_mesh as jax_mesh

    if fall == "structure":
        jsegs = [_segment(1, 200), _segment(2, 150, positions=False)]
    else:
        jsegs = [_segment(1, 200, pos_scale=1 << 22), _segment(2, 150)]
    psegs = [carry(sr) for sr in jsegs]
    phrases = [F.ByPhrase("body", ["t00000", "t00001"]),
               F.Or(F.ByTerm("body", "t00004"), F.ByPhrase("body", ["t00001", "t00000"]))]
    pair = (JaxSearcher(jsegs, jax_mesh(jax.devices()[:2])), ShardedSearcher(psegs, device="cpu"))
    jprep, pprep = _hold(phrases, pair, psegs, BM25(), False)
    assert not any(st["phrase_static"] for _q, _a, st, _l in jprep._calls)
    assert not any(_keys_form(pprep)) and {m for _q, m, _w, _c in pprep.groups} == {"dense"}
    assert all(kw["aux_rows"] and not any(dev for dev, _j in kw["aux_rows"])
               for _t, _q, _f, _a, kw in pprep.calls)


def test_segment_without_the_field_matches_jax():
    """A segment that lacks the queried field holds no doc of it: its
    groups decode zero pools of the groups' widths, and the results equal
    the JAX package's, which stacks zero pools there."""
    import jax

    from iresearch_tpu.parallel import ShardedSearcher as JaxSearcher
    from iresearch_tpu.parallel import make_mesh as jax_mesh

    jsegs = [_segment(3, 200), _segment(4, 120, field="title"), _segment(5, 90)]
    psegs = [carry(sr) for sr in jsegs]
    pair = (JaxSearcher(jsegs, jax_mesh(jax.devices()[:1])), ShardedSearcher(psegs, device="cpu"))
    filters = [F.ByTerm("body", "t00007"), F.Or(F.ByTerm("body", "t00003"), F.ByTerm("title", "t00030")),
               F.And(F.ByTerm("body", "t00002"), F.ByTerm("body", "t00009"))]
    _hold(filters, pair, psegs, BM25(), True)


def test_grid_narrower_than_nd_pad():
    """Where the largest segment's padded count (9,216 for 9,000 docs) is
    not the power of two every segment runs at (16,384), a dense span's
    lanes past the grid hold freq 0 (``exec/executor.py:dense_contrib``).
    The JAX body needs the two equal (it reshapes the span to nd), so the
    port is held against its own ``HostQuery``."""
    from iresearch_tpu_torch import bench_mix
    from iresearch_tpu_torch.index.segment import SegmentReader
    from iresearch_tpu_torch.search.scorers import BM25 as PBM25

    psegs = [SegmentReader("n0", bench_mix.build_segment_data(9_000)),
             SegmentReader("n1", bench_mix.build_segment_data(700, bench_mix.SEED + 1))]
    ps = ShardedSearcher(psegs, device="cpu")
    lay = ps._dense_layout("body")
    assert lay.terms and lay.stride * 128 == 9_216 and ps.nd_pad == 16_384
    term_at = bench_mix._ranked(psegs[0])[0]
    T = lambda r: to_port(F.ByTerm("body", term_at(r)))  # noqa: E731
    filters = [T(0), T(3), to_port(F.Or(F.ByTerm("body", term_at(1)), F.ByTerm("body", term_at(2)))),
               to_port(F.And(F.ByTerm("body", term_at(0)), F.ByTerm("body", term_at(400))))]
    for wand in (False, True):
        prep = ps.prepare_many(filters, PBM25(), wand=wand)
        assert {c[0] for c in prep.calls} & {"fold", "wand"}
        for flt, hits in zip(filters, prep.top_k(10)):
            assert_topk_equiv(hits, HostQuery(flt, psegs, PBM25()).top_k(10))


def test_searcher_needs_a_device_and_port_objects(segs):
    """Without a ``device`` the searcher takes the card and raises where
    there is none; it takes none of the JAX package's readers, filters or
    scorers."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ShardedSearcher(segs.port)
    with pytest.raises(TypeError, match="SegmentReader"):
        ShardedSearcher(segs.jax, device="cpu")
    ps = ShardedSearcher(segs.port, device="cpu")
    with pytest.raises(TypeError, match="Scorer"):
        ps.prepare_many([to_port(QUERIES[0])], BM25())
    with pytest.raises(TypeError, match="Filter"):
        ps.prepare_many([QUERIES[0]], to_port(BM25()))


# --- the fused pass: one CUDA graph per signature group ---------------------

PHRASES = [
    F.ByPhrase("body", ["ant", "bee"]),
    F.ByPhrase("body", ["ant", (2, "bee"), "cat"]),
    F.Or(F.ByTerm("body", "owl"), F.ByPhrase("body", ["fox", "ant"])),
    F.BySamePosition([("body", "ant"), ("body", "ant")]),
]
FUSED_CASES = {
    "bm25": (QUERIES, BM25(), False),
    "tfidf": (QUERIES, TFIDF(), False),
    "wand": (WAND_QUERIES, BM25(), True),
    "keys": (PHRASES, BM25(), False),
}


def _sharded_entries(pprep, k=10):
    from iresearch_tpu_torch.exec import batch as B

    return [B._FUSED_KINDS["sharded"].get(pprep.fused_key(gi, min(k, pprep.searcher.nd_pad, g[3])))
            for gi, g in enumerate(pprep.groups)]


def _same_runs(got, want):
    for (gv, gd), (wv, wd) in zip(got, want):
        assert torch.equal(gd, wd) and torch.equal(gv, wv)


@pytest.mark.parametrize("case", sorted(FUSED_CASES))
def test_fused_sharded_equals_eager_and_jax(searchers, segs, case):
    """``run(k)`` (fused by default) makes one "sharded" entry per
    signature group and equals ``run(fused=False)`` and the plain run bit
    for bit, and the JAX package's ``ShardedSearcher`` (through ``_hold``,
    which also holds it against ``HostQuery``); the keys form's phrases
    run inside the groups' entries."""
    from iresearch_tpu_torch.exec import batch as B

    B.clear_fused_cache()
    filters, scorer, wand = FUSED_CASES[case]
    _jprep, pprep = _hold(filters, searchers, segs.port, scorer, wand)
    entries = _sharded_entries(pprep)
    assert all(e is not None for e in entries) and len(B._FUSED_KINDS["sharded"]) == len(entries)
    assert all(_keys_form(pprep)) == (case == "keys")
    got = pprep.run(10)
    assert all(e.hits == 1 for e in entries)
    _same_runs(got, pprep.run(10, fused=False))
    _same_runs(got, pprep.run(10, plain=True))
    B.clear_fused_cache()


def test_fresh_prepare_many_hits_per_group(searchers, segs):
    """A fresh ``prepare_many`` of the same queries (and one with two
    queries of a group swapped, so that its packed arrays differ) hits
    every group's entry that the first made, phrases in the keys form
    among them: no new entry, each result its own eager one, the first
    call's tensors unchanged."""
    from iresearch_tpu_torch.exec import batch as B

    B.clear_fused_cache()
    _js, ps = searchers
    # hen and ibis share a group, as jay and kite do; the phrases run in
    # the keys form, whose fresh ``_KeysRows`` must match the first's
    filters = [to_port(f) for f in WAND_QUERIES + PHRASES[:2]] + [
        to_port(F.ByTerm("body", w)) for w in ("hen", "ibis", "jay", "kite")]
    first = ps.prepare_many(filters, to_port(BM25()), wand=True)
    assert any(_keys_form(first))
    got1 = first.run(10)
    kept = [(v.clone(), d.clone()) for v, d in got1]
    entries = _sharded_entries(first)
    a, b = next(qis[:2] for qis, *_r in first.groups
                if len(qis) >= 2 and filters[qis[0]] != filters[qis[1]])
    swapped = list(filters)
    swapped[a], swapped[b] = swapped[b], swapped[a]
    for n, fl in enumerate((swapped, filters), start=1):
        fresh = ps.prepare_many(fl, to_port(BM25()), wand=True)
        got = fresh.run(10)
        assert _sharded_entries(fresh) == entries and all(e.hits == n for e in entries)
        assert len(B._FUSED_KINDS["sharded"]) == len(entries)
        _same_runs(got, fresh.run(10, fused=False))
        if fl is swapped:
            assert not torch.equal(got1[a][1], got[a][1]) and torch.equal(got1[a][1], got[b][1])
    _same_runs(got1, kept)
    B.clear_fused_cache()


def test_packed_upload_equals_per_array_uploads(scale_searchers, monkeypatch):
    """Every host-made argument of every group's calls (rows, avgdl,
    leaf_min, dense starts and weights, WAND bounds, sparse aux pairs,
    phrase keys and weights), rebuilt from the group's one packed buffer,
    equals the per-array upload it replaces (``ShardedSearcher._up``):
    dtype, shape and bits, each section 256-byte aligned; the segments'
    resident tensors pass as they are. One buffer per group and shard: here
    one shard holds every segment."""
    from test_torch_fused import _compare_tree

    import iresearch_tpu_torch.parallel.sharded as sh

    _js, ps = scale_searchers
    seen = []
    real = sh._pack_args
    monkeypatch.setattr(sh, "_pack_args", lambda trees, dev: seen.append(trees) or real(trees, dev))
    for wand in (False, True):
        seen.clear()
        prep = ps.prepare_many([to_port(f) for f in SCALE_QUERIES], to_port(BM25()), wand=wand)
        assert len(seen) == len(prep.groups)
        n = 0
        for gi, trees in enumerate(seen):
            calls = [c for c in prep._calls if c[6] == gi]
            assert len(calls) == len(trees) == len(ps.local)
            for c, raw in zip(calls, trees):
                n += _compare_tree(c[3], raw, prep._packs[gi][0][1])
        tiers = {c[0] for c in prep.calls}
        assert n > 0 and ({"wand", "gridmix", "direct"} <= tiers if wand else "aux" in tiers), tiers


# --- the mesh of devices: several shards in one process ----------------------

MESH_CASES = [("segs", 2), ("segs", 4), ("segs", 8), ("scale", 2), ("scale", 4)]
# the WAND queries of a mesh that the module's JAX searchers do not span:
# JAX compiles each group anew there (~3 s a group at per_shard 4), so a
# part of the mix: a conjunction, an expansion and a WAND disjunction; on
# the 16,384-doc index a dense term, a sparse one, gridmix and a phrase
MESH_WAND = {
    "segs": [WAND_QUERIES[i] for i in (3, 5, 8)],
    "scale": [SCALE_QUERIES[i] for i in (0, 1, 4, 8)],
}


@pytest.mark.parametrize("index,D", MESH_CASES, ids=[f"{i}-{d}" for i, d in MESH_CASES])
def test_mesh_of_devices_matches_jax(request, index, D):
    """``ShardedSearcher(segments, devices=["cpu"] * D)`` against the JAX
    package's searcher over a mesh of D virtual devices: the same D, S,
    ``per_shard`` and doc bases, segment ``s`` on shard ``s // per_shard``
    (padding segments left out: D = 8 over the seven segments leaves the
    last shard without one), and the same results, fused and eager, for
    WAND and the keys-form phrases (``_hold``: the exactness gate against
    JAX and ``HostQuery``). The 16,384-doc index takes D = 2 and 4: its
    JAX uniform dense pools stack the real segments only. Where the
    module's JAX searcher spans another D, the WAND run takes
    ``MESH_WAND``."""
    import jax

    from iresearch_tpu.parallel import ShardedSearcher as JaxSearcher
    from iresearch_tpu.parallel import make_mesh as jax_mesh

    if index == "segs":
        jsegs, psegs = request.getfixturevalue("segs")
        js = request.getfixturevalue("searchers")[0]
        runs = [(WAND_QUERIES, True), (PHRASES, False)]
    else:
        jsegs, psegs = request.getfixturevalue("scale")
        js = request.getfixturevalue("scale_searchers")[0]
        runs = [(SCALE_QUERIES, True)]
    if js.D != D:
        js = JaxSearcher(jsegs, jax_mesh(jax.devices()[:D]))
        runs[0] = (MESH_WAND[index], True)
    cpu = torch.device("cpu")
    ps = ShardedSearcher(psegs, devices=["cpu"] * D)
    assert (ps.D, ps.S, ps.per_shard) == (js.D, js.S, js.per_shard) == (D, js.S, js.S // D)
    assert ps.mesh == (None, 0, 1, (cpu,) * D) and ps.device == cpu
    np.testing.assert_array_equal(ps._doc_base, js._doc_base)
    assert ps.shards == [
        (g, cpu, [si for si in range(js.S) if si // js.per_shard == g and si < len(psegs)])
        for g in range(D)]
    assert ps.local == list(range(len(psegs)))
    for filters, wand in runs:
        _jprep, pprep = _hold(filters, (js, ps), psegs, BM25(), wand)
        assert all(len(packs) == D for packs in pprep._packs)
        keys = _keys_form(pprep)
        assert all(keys) if not wand else any(keys) == (index == "scale" or D == 8)
        _same_runs(pprep.run(10), pprep.run(10, fused=False))


def test_group_entry_holds_every_shard(segs, monkeypatch):
    """At ``IRS_FUSED_CACHE_MAX`` = the number of signature groups, a pass
    over 8 shards (7 of them holding a segment) evicts none of its own
    graphs: a group's entry in the "sharded" LRU holds a pass on each shard
    with segments, so the LRU counts groups, and the second run hits every
    group. An entry per graph would have evicted all but the last groups'
    within the first pass."""
    from iresearch_tpu_torch.exec import batch as B

    B.clear_fused_cache()
    ps = ShardedSearcher(segs.port, devices=["cpu"] * 8)
    prep = ps.prepare_many([to_port(f) for f in WAND_QUERIES], to_port(BM25()), wand=True)
    monkeypatch.setattr(B, "_FUSED_CACHE_MAX", len(prep.groups))
    first = prep.run(10)
    entries = _sharded_entries(prep)
    assert len(prep.groups) > 1 and len(B._FUSED_KINDS["sharded"]) == len(prep.groups)
    assert all(e is not None and len(e.passes) == 7 for e in entries)
    assert len({id(p) for e in entries for p in e.passes}) == 7 * len(entries)
    _same_runs(prep.run(10), first)
    assert _sharded_entries(prep) == entries and all(e.hits == 1 for e in entries)
    B.clear_fused_cache()


_RANK = r"""
import pickle, sys
import torch.distributed as dist
from iresearch_tpu_torch.index.segment import carry_segment
from iresearch_tpu_torch.parallel import ShardedSearcher

rank, port, src, dst = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
blobs, filters, scorer = pickle.load(open(src, "rb"))
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank, world_size=2)
segs = [carry_segment(n, b, m) for n, b, m in blobs]
s = ShardedSearcher(segs, device="cpu")
assert (s.D, s.per_shard, s.local) == (2, 3, list(range(3 * rank, 3 * rank + 3)))
out = [(v.numpy(), d.numpy()) for v, d in s.prepare_many(filters, scorer, wand=True).run(10)]
if rank == 0:
    pickle.dump(out, open(dst, "wb"))
dist.destroy_process_group()
"""


def test_two_processes_gloo_match_jax(segs, tmp_path):
    """Six segments over two processes of a ``gloo`` group (``per_shard``
    3, candidates joined by ``all_gather``) against the JAX package on a
    two-device mesh (``per_shard`` 3)."""
    import jax

    from iresearch_tpu.formats.segment_io import write_segment
    from iresearch_tpu.parallel import ShardedSearcher as JaxSearcher
    from iresearch_tpu.parallel import make_mesh as jax_mesh

    jsegs = segs.jax[:6]
    filters = WAND_QUERIES[:4]
    src, dst = tmp_path / "in.pkl", tmp_path / "out.pkl"
    blobs = [(sr.name, write_segment(sr.data), np.flatnonzero(~sr.alive)) for sr in jsegs]
    with open(src, "wb") as f:
        pickle.dump((blobs, [to_port(x) for x in filters], to_port(BM25())), f)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    path = os.environ.get("PYTHONPATH")
    env = dict(os.environ, PYTHONPATH=REPO + (os.pathsep + path if path else ""))
    procs = [subprocess.Popen([sys.executable, "-c", _RANK, str(r), str(port), str(src), str(dst)],
                              cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for r in range(2)]
    try:
        errs = [p.communicate(timeout=240)[1] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), [e.decode()[-2000:] for e in errs]
    with open(dst, "rb") as f:
        got = pickle.load(f)
    js = JaxSearcher(jsegs, jax_mesh(jax.devices()[:2]))
    assert js.per_shard == 3
    want = js.prepare_many(filters, BM25(), wand=True).run(10)
    for (gv, gd), (wv, wd) in zip(got, want):
        assert_topk_near((gv, gd), (np.asarray(wv), np.asarray(wd)))


# --- the join inside the group body: every rank runs every group -------------

_GROUP_RANK = r"""
import pickle, sys
import torch.distributed as dist
from iresearch_tpu_torch.exec import batch as B
from iresearch_tpu_torch.index.segment import carry_segment
from iresearch_tpu_torch.parallel import ShardedSearcher
from iresearch_tpu_torch.parallel.multihost import dist_calls
from iresearch_tpu_torch.parallel.sharded import Mesh

rank, port, src, dst = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
cases, filters, scorer = pickle.load(open(src, "rb"))
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank, world_size=2)
out = {}
for name, (blobs, ndev) in cases.items():
    s = ShardedSearcher([carry_segment(n, b, m) for n, b, m in blobs], devices=["cpu"] * ndev)
    m = s.mesh
    # the NCCL mesh's group body, its join inside, run over gloo on the CPU
    s.mesh = Mesh(m.group, m.rank, m.world, m.devices, join_in_graph=True)
    prep = s.prepare_many(filters, scorer, wand=True)
    with dist_calls() as calls:
        runs = [prep.run(10), prep.run(10), prep.run(10, fused=False), prep.run(10, plain=True)]
    entries = len(B._FUSED_KINDS["sharded"])
    B._WARM_UP.on = True  # as in a capture's warm-up: no collective
    try:
        with dist_calls() as warm:
            prep.run(10, fused=False)
    finally:
        B._WARM_UP.on = False
    B.clear_fused_cache()
    out[name] = (s.local, len(prep.groups), dict(calls), dict(warm), entries,
                 [[(v.numpy(), d.numpy()) for v, d in r] for r in runs])
pickle.dump(out, open(f"{dst}.{rank}", "wb"))
dist.destroy_process_group()
"""
# per case: (the first segments of the module's reader, shards per
# process (two processes, so D = 2 x shards), the JAX mesh's devices: its
# padded S takes 7 segments on 4 devices, but not 2, so the case whose
# second process holds no segment is held against 2)
GROUP_CASES = {"d2": (6, 1, 2), "d4": (7, 2, 4), "empty_rank": (2, 2, 2)}


@pytest.fixture(scope="module")
def group_runs(segs, tmp_path_factory):
    """Every ``GROUP_CASES`` case in two processes of one ``gloo`` group
    on the CPU, each searcher's mesh marked as joining inside the group
    body (what an NCCL mesh captures per group): per rank and case its
    local segments, groups, calls into ``torch.distributed``, "sharded"
    entries, and its fused, fused again, eager and plain results."""
    from iresearch_tpu.formats.segment_io import write_segment

    tmp = tmp_path_factory.mktemp("group")
    src, dst = tmp / "in.pkl", tmp / "out.pkl"
    cases = {name: ([(sr.name, write_segment(sr.data), np.flatnonzero(~sr.alive))
                     for sr in segs.jax[:n]], ndev)
             for name, (n, ndev, _jd) in GROUP_CASES.items()}
    with open(src, "wb") as f:
        pickle.dump((cases, [to_port(x) for x in MESH_WAND["segs"]], to_port(BM25())), f)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    path = os.environ.get("PYTHONPATH")
    env = dict(os.environ, PYTHONPATH=REPO + (os.pathsep + path if path else ""))
    procs = [subprocess.Popen([sys.executable, "-c", _GROUP_RANK, str(r), str(port), str(src),
                               str(dst)],
                              cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for r in range(2)]
    try:
        errs = [p.communicate(timeout=240)[1] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), [e.decode()[-2000:] for e in errs]
    runs = []
    for r in range(2):
        with open(f"{dst}.{r}", "rb") as f:
            runs.append(pickle.load(f))
    return runs


@pytest.mark.parametrize("case", sorted(GROUP_CASES))
def test_group_body_join_over_gloo_matches_jax(segs, group_runs, case):
    """The group body with the join inside it, run by both processes of a
    ``gloo`` group on the CPU (fused, where the CPU runs the entry's body
    eagerly; again; eager; plain): one ``all_gather`` per group per run in
    every process, a process without segments (``empty_rank``) included,
    so no rank waits on another, and none inside a capture's warm-up
    (where a miss would otherwise issue one more than a hit); every run of both ranks the same, and the
    same as the JAX package's searcher on 2 or 4 virtual devices (the
    exactness gate) over ``MESH_WAND``'s queries, which its padded ``S``
    takes."""
    import jax

    from iresearch_tpu.parallel import ShardedSearcher as JaxSearcher
    from iresearch_tpu.parallel import make_mesh as jax_mesh

    n, ndev, jd = GROUP_CASES[case]
    per_shard = -(-n // (2 * ndev))
    js = JaxSearcher(segs.jax[:n], jax_mesh(jax.devices()[:jd]))
    want = _jax_run(js, MESH_WAND["segs"], BM25(), True, 10)[1]
    ranks = [r[case] for r in group_runs]
    for rank, (local, groups, calls, warm, entries, runs) in enumerate(ranks):
        assert local == [si for si in range(n) if si // (per_shard * ndev) == rank]
        assert calls == {"all_gather_into_tensor": 4 * groups} and 0 < entries <= groups
        assert warm == {}
        for run in runs:
            for (gv, gd), (wv, wd) in zip(run, runs[0]):
                np.testing.assert_array_equal(gd, wd)
                np.testing.assert_array_equal(gv, wv)
        for (gv, gd), (wv, wd), (ov, od) in zip(runs[0], want, ranks[0][5][0]):
            assert_topk_near((gv, gd), (np.asarray(wv), np.asarray(wd)))
            np.testing.assert_array_equal(gd, od)
            np.testing.assert_array_equal(gv, ov)
    assert (ranks[1][0] == []) == (case == "empty_rank")


@pytest.mark.parametrize("devices", [["cpu"], ["cpu", "cpu"], ["cuda:0", "cuda:1"]],
                         ids=["cpu", "cpu2", "two-cards"])
def test_nccl_mesh_refuses_devices_not_one_card(monkeypatch, devices):
    """``make_mesh`` on a group that says it is NCCL's (the backend
    monkeypatched: this torch has no NCCL) raises unless the devices are
    one card; it does not fall back to another backend."""
    import torch.distributed as dist

    group = object()
    monkeypatch.setattr(dist, "get_backend", lambda g=None: "nccl")
    monkeypatch.setattr(dist, "get_rank", lambda g=None: 0)
    monkeypatch.setattr(dist, "get_world_size", lambda g=None: 1)
    with pytest.raises(ValueError, match="one card of its own"):
        make_mesh(devices, group)
    monkeypatch.setattr(dist, "get_backend", lambda g=None: "gloo")
    mesh = make_mesh(devices, group)
    assert mesh == (group, 0, 1, tuple(torch.device(d) for d in devices))
    assert not mesh.join_in_graph
