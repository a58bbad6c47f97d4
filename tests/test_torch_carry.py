"""Carrying data from the JAX package to the port, and the port's own host
layers held against the originals they were copied from, on the CPU.

The port imports nothing of ``iresearch_tpu`` and never accepts its
objects: a test builds a segment, filter or scorer with the JAX package
and hands the port its own copy of it:

* ``carry(sr)`` — a JAX ``SegmentReader`` as the port's, through the
  segment file format both packages share (``write_segment`` bytes into
  ``carry_segment``), deleted docs included;
* ``carried(reader)`` — both packages' segment lists of a JAX reader;
* ``to_port(obj)`` — a JAX filter, phrase part or scorer rebuilt as the
  port's class of the same name, field by field (``to_jax`` the reverse,
  for the port's ``bench_mix`` task lists);
* ``both_knobs(**kv)`` — the planner knobs set in both packages (each has
  its own ``exec/plan.py`` module and ``DSLICE_PAD``) for one block.

Other test files import these by module name (``from test_torch_carry
import ...``), as pytest puts this directory on the path. The tests below
hold every copied module against its original on the same inputs:
encoded pools, segment files, term dictionary, norms, dense grid, plan
tier and groups, skyline schedules, and ``HostQuery`` results.
"""

import contextlib
import dataclasses
from collections import namedtuple

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from iresearch_tpu.search import filters as JF  # noqa: E402
from iresearch_tpu.search import scorers as JS  # noqa: E402
from iresearch_tpu_torch import bench_mix  # noqa: E402
from iresearch_tpu_torch.search import filters as PF  # noqa: E402
from iresearch_tpu_torch.search import scorers as PS  # noqa: E402

_TO_PORT = {JF.__name__: PF, JS.__name__: PS}
_TO_JAX = {PF.__name__: JF, PS.__name__: JS}


def _rebuild(obj, modules):
    if isinstance(obj, tuple):
        return tuple(_rebuild(x, modules) for x in obj)
    mod = modules.get(type(obj).__module__)
    if mod is None:
        return obj
    out = object.__new__(getattr(mod, type(obj).__name__))
    for f in dataclasses.fields(obj):
        object.__setattr__(out, f.name, _rebuild(getattr(obj, f.name), modules))
    return out


def to_port(obj):
    """``obj`` with every JAX-package filter, phrase part and scorer in it
    rebuilt as the port's class of the same name, field by field (the
    classes are frozen dataclasses; tuples convert element-wise)."""
    return _rebuild(obj, _TO_PORT)


def to_jax(obj):
    """The inverse of ``to_port``."""
    return _rebuild(obj, _TO_JAX)


def carry(sr):
    """The port's reader over a JAX ``SegmentReader``'s segment, through
    the shared file format, with the same deleted docs. A segment without
    inline norm pools (format v4) is written as v4, which leaves the JAX
    reader untouched (the v5+ writer derives the pools in place)."""
    from iresearch_tpu.formats.segment_io import FORMAT_V4, write_segment
    from iresearch_tpu_torch.index.segment import carry_segment

    legacy = any(fp.nrm_words is None for fp in sr.data.fields.values())
    blob = write_segment(sr.data, version=FORMAT_V4) if legacy else write_segment(sr.data)
    return carry_segment(sr.name, blob, np.flatnonzero(~sr.alive))


Segs = namedtuple("Segs", "jax port")


def carried(reader) -> Segs:
    """(JAX segments, the port's carried segments) of a JAX reader."""
    segs = list(reader.segments)
    return Segs(segs, [carry(sr) for sr in segs])


def jax_bench_data(num_docs: int):
    """``bench_mix.build_segment_data`` through the JAX package's own
    inverter and encoder (the same corpus law and seed)."""
    from iresearch_tpu.formats.postings import encode_field_postings
    from iresearch_tpu.formats.spec import IndexFeatures
    from iresearch_tpu.index.invert import invert_numpy
    from iresearch_tpu.index.segment import SegmentData

    lens, tids = bench_mix.build_corpus(num_docs)
    doc_of_tok = np.repeat(np.arange(num_docs), lens)
    starts = np.cumsum(lens) - lens
    pos = (np.arange(len(tids), dtype=np.int64) - np.repeat(starts, lens)).astype(np.uint32)
    inv = invert_numpy(tids, doc_of_tok, pos, bench_mix.VOCAB, num_docs)
    present = np.flatnonzero(np.diff(inv.term_ptr) > 0)
    terms = [b"t%06d" % t for t in present]
    offs = np.zeros(len(terms) + 1, np.uint64)
    offs[1:] = np.cumsum([len(t) for t in terms])
    tp = np.concatenate([inv.term_ptr[present], [inv.term_ptr[-1]]])
    fp = encode_field_postings(
        inv.e_doc, inv.e_freq, tp, b"".join(terms), offs, inv.norms, inv.pos_flat,
        IndexFeatures.FREQ | IndexFeatures.POS,
    )
    return SegmentData(num_docs, {"body": fp}, {})


def jax_index_reader(ndocs, nwords, prefix, zipf, seed, maxlen, deletes=(), version=None):
    """A JAX ``DirectoryReader`` over ``ndocs`` Zipf docs of ``nwords``
    words written by the JAX package's IndexWriter (a stored ``id``
    column; ``deletes`` removed in a second commit)."""
    from iresearch_tpu.index.reader import DirectoryReader
    from iresearch_tpu.index.writer import Field, IndexWriter, IndexWriterOptions
    from iresearch_tpu.store.directory import MemoryDirectory

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
            w.remove(JF.ByTerm("id", str(i)))
        if deletes:
            w.commit()
    return DirectoryReader.open(d)


def jax_bench_reader(name: str, num_docs: int, masked_docs=None):
    from iresearch_tpu.index.segment import SegmentReader

    return SegmentReader(name, jax_bench_data(num_docs), masked_docs=masked_docs)


@contextlib.contextmanager
def _jax_knobs(**knobs):
    import iresearch_tpu.exec.plan as planmod
    import iresearch_tpu.exec.plancache as plancache
    import iresearch_tpu.index.segment as segmod

    mods = {n: segmod if n == "DSLICE_PAD" else planmod for n in knobs}
    old = {n: getattr(mods[n], n) for n in knobs}
    plancache.clear_plan_cache()
    try:
        for n, v in knobs.items():
            setattr(mods[n], n, v)
        yield
    finally:
        for n, v in old.items():
            setattr(mods[n], n, v)
        plancache.clear_plan_cache()


@contextlib.contextmanager
def both_knobs(**knobs):
    """Planner knobs set in both packages for the block (plan caches
    cleared around it, as their keys hold no knob)."""
    with _jax_knobs(**knobs), bench_mix.planner_knobs(**knobs):
        yield


# --- parity of the copies ------------------------------------------------


def _same(a, b, what):
    if isinstance(a, (bytes, memoryview)) or isinstance(b, (bytes, memoryview)):
        assert bytes(a) == bytes(b), what
    elif a is None or b is None:
        assert a is None and b is None, what
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{what}[{i}]")
    elif dataclasses.is_dataclass(b) and not isinstance(b, (JF.Filter, JS.Scorer)):
        # a phrase spec of a ``device_aux`` row: each package has its own
        # class of the same name
        assert type(a).__name__ == type(b).__name__, what
        for f in dataclasses.fields(b):
            _same(getattr(a, f.name), getattr(b, f.name), f"{what}.{f.name}")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype, b.dtype, a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=what)
    else:
        assert a == b, (what, a, b)


def _same_fields(port_fp, jax_fp, what):
    for f in dataclasses.fields(jax_fp):
        _same(getattr(port_fp, f.name), getattr(jax_fp, f.name), f"{what}.{f.name}")


def _same_dense(pc, jc, what):
    assert (pc is None) == (jc is None), what
    if jc is not None:
        for f in dataclasses.fields(jc):
            _same(getattr(pc, f.name), getattr(jc, f.name), f"{what}.{f.name}")


@pytest.fixture(scope="module")
def bench20k():
    """The bench corpus at 20k docs, built by the JAX package, and the
    port's own build of it."""
    jsr = jax_bench_reader("carry20k", 20_000)
    return jsr, bench_mix.build_segment_data(20_000)


def test_bench_segment_build_matches_jax(bench20k):
    """The port's inverter and encoder give the JAX package's pools, term
    dictionary and norms, and the same segment file bytes."""
    from iresearch_tpu.formats.segment_io import write_segment as jax_write
    from iresearch_tpu_torch.formats.segment_io import write_segment

    jsr, pdata = bench20k
    assert pdata.num_docs == jsr.num_docs
    _same_fields(pdata.fields["body"], jsr.data.fields["body"], "body")
    assert write_segment(pdata) == jax_write(jsr.data)


@pytest.fixture(scope="module")
def cand_reader():
    """``tests/test_candidates.py``'s corpus (800 docs, two deleted),
    written by the JAX package's IndexWriter, with a stored column."""
    return jax_index_reader(800, 30, "t", 1.4, 31, 24, deletes=(13, 400))


@pytest.mark.parametrize("which", ["bench20k", "cand_reader", "legacy_v4"])
def test_carry_segment_keeps_fields_columns_and_deletes(request, which):
    """``carry_segment`` reads the JAX package's file into the same
    arrays, term dictionary, stored columns and deleted docs; the port's
    dense grid over them equals the JAX package's. A v4 segment (no
    inline norm pools) stays v4 and the JAX reader is left as it was."""
    if which == "bench20k":
        jsrs = [request.getfixturevalue("bench20k")[0]]
    elif which == "cand_reader":
        jsrs = list(request.getfixturevalue("cand_reader").segments)
    else:
        jsrs = list(jax_index_reader(300, 20, "t", 1.4, 5, 24, deletes=(7,),
                                     version="iresearch_tpu/4").segments)
    for jsr in jsrs:
        psr = carry(jsr)
        if which == "legacy_v4":
            assert jsr.data.fields["body"].nrm_words is None
            assert psr.data.fields["body"].nrm_words is None
        assert psr.num_docs == jsr.num_docs and psr.name == jsr.name
        _same(psr.alive, jsr.alive, "alive")
        assert psr.has_deletes == jsr.has_deletes
        assert sorted(psr.data.fields) == sorted(jsr.data.fields)
        for name, jfp in jsr.data.fields.items():
            _same_fields(psr.data.fields[name], jfp, name)
            assert list(psr.terms(name)) == list(jsr.terms(name))
            _same_dense(psr.dense_cache(name), jsr.dense_cache(name), f"dense {name}")
        for name, jcol in jsr.data.columns.items():
            pcol = psr.column(name)
            assert pcol.kind == jcol.kind
            assert list(pcol.items()) == list(jcol.items())
        dead = np.flatnonzero(~jsr.alive)
        assert not psr.alive[dead].any() and psr.live_docs_count == jsr.live_docs_count
    if which == "cand_reader":
        np.testing.assert_array_equal(np.flatnonzero(~jsrs[-1].alive), [13, 400])


def test_port_segment_file_reads_in_jax(bench20k):
    """The reverse direction: the JAX package reads the port's file."""
    from iresearch_tpu.formats.segment_io import read_segment as jax_read
    from iresearch_tpu_torch.formats.segment_io import write_segment

    jsr, pdata = bench20k
    back = jax_read(write_segment(pdata))
    _same_fields(pdata.fields["body"], back.fields["body"], "body")


def test_filter_and_scorer_conversion_round_trips():
    """Every filter class, phrase part and scorer rebuilds field by field,
    equal to the port's own construction and back."""
    jax_objs = [
        JF.ByTerm("body", "a", boost=2.0),
        JF.ByTerms("body", [("a", 1.5), "b"], min_match=2),
        JF.ByPrefix("body", "ab", scored_terms_limit=3),
        JF.ByWildcard("body", "a%b_"),
        JF.ByEditDistance("body", "abc", max_distance=2, prefix="a"),
        JF.ByRange("body", "a", "c", include_high=False),
        JF.ByGranularRange("num", 1.0, 9.0),
        JF.ByPhrase("body", ["a", (2, JF.PhrasePrefix("b")), JF.PhraseSet(["c", "d"]),
                             JF.PhraseFuzzy("e"), JF.PhraseWildcard("f%")]),
        JF.BySamePosition([("body", "a"), ("title", "b")]),
        JF.ByNgramSimilarity("body", ["ab", "bc"], threshold=0.5),
        JF.ByColumnExistence("id", prefix_match=True),
        JF.ByNested(JF.ByTerm("kind", "p"), JF.ByTerm("body", "a"), max_match=3),
        JF.And(JF.ByTerm("body", "a"), JF.Not(JF.ByTerm("body", "b")), merge="max"),
        JF.Or(JF.ByTerm("body", "a"), JF.All(), JF.Empty(), min_match=2),
        JF.Proxy(JF.ByTerm("body", "a")),
        JS.BM25(k=0.9, b=0.4), JS.TFIDF(with_norms=False), JS.BoostScore(),
    ]
    port_objs = [
        PF.ByTerm("body", "a", boost=2.0),
        PF.ByTerms("body", [("a", 1.5), "b"], min_match=2),
        PF.ByPrefix("body", "ab", scored_terms_limit=3),
        PF.ByWildcard("body", "a%b_"),
        PF.ByEditDistance("body", "abc", max_distance=2, prefix="a"),
        PF.ByRange("body", "a", "c", include_high=False),
        PF.ByGranularRange("num", 1.0, 9.0),
        PF.ByPhrase("body", ["a", (2, PF.PhrasePrefix("b")), PF.PhraseSet(["c", "d"]),
                             PF.PhraseFuzzy("e"), PF.PhraseWildcard("f%")]),
        PF.BySamePosition([("body", "a"), ("title", "b")]),
        PF.ByNgramSimilarity("body", ["ab", "bc"], threshold=0.5),
        PF.ByColumnExistence("id", prefix_match=True),
        PF.ByNested(PF.ByTerm("kind", "p"), PF.ByTerm("body", "a"), max_match=3),
        PF.And(PF.ByTerm("body", "a"), PF.Not(PF.ByTerm("body", "b")), merge="max"),
        PF.Or(PF.ByTerm("body", "a"), PF.All(), PF.Empty(), min_match=2),
        PF.Proxy(PF.ByTerm("body", "a")),
        PS.BM25(k=0.9, b=0.4), PS.TFIDF(with_norms=False), PS.BoostScore(),
    ]
    for j, p in zip(jax_objs, port_objs):
        got = to_port(j)
        assert type(got) is type(p) and got == p and hash(got) == hash(p), (j, p)
        assert to_jax(p) == j


def _plans_equal(pp, jp, what):
    for f in dataclasses.fields(jp):
        if f.name == "cache":
            continue
        a, b = getattr(pp, f.name), getattr(jp, f.name)
        if f.name == "groups":
            assert len(a) == len(b), what
            for i, (x, y) in enumerate(zip(a, b)):
                for g in dataclasses.fields(y):
                    _same(getattr(x, g.name), getattr(y, g.name), f"{what} group {i}.{g.name}")
        elif f.name == "dense_spans":
            assert len(a) == len(b), what
            for i, (x, y) in enumerate(zip(a, b)):
                for g in dataclasses.fields(y):
                    _same(getattr(x, g.name), getattr(y, g.name), f"{what} span {i}.{g.name}")
        else:
            _same(a, b, f"{what}.{f.name}")


def _plan_both(jsr, psr, flt, scorer, wand, device_phrase=False):
    """(port plan, JAX plan) of one filter on one segment, compiled fresh
    by each package's PlanCompiler over its own HostQuery."""
    from iresearch_tpu.exec.plan import PlanCompiler as JaxCompiler
    from iresearch_tpu.search.host_eval import HostQuery as JaxHostQuery
    from iresearch_tpu_torch.exec.plan import PlanCompiler
    from iresearch_tpu_torch.search.host_eval import HostQuery

    pflt, pscorer = to_port(flt), to_port(scorer)
    pp = PlanCompiler(HostQuery(pflt, [psr], pscorer), pscorer).compile(
        pflt, 0, wand=wand, device_phrase=device_phrase)
    jp = JaxCompiler(JaxHostQuery(flt, [jsr], scorer), scorer).compile(
        flt, 0, wand=wand, device_phrase=device_phrase)
    return pp, jp


def _task_lists(psr, lists=("mix", "breadth", "tiers")):
    """The tasks of the port's bench lists, as JAX filters, with their
    WAND flags and planner knobs."""
    tasks = []
    if "mix" in lists:
        tasks += [(c, to_jax(f), True, {}) for c, f in bench_mix.task_mix(psr)]
    if "breadth" in lists:
        tasks += [(n, to_jax(f), w, {}) for n, f, w in bench_mix.breadth_tasks(psr)]
    if "tiers" in lists:
        tasks += [(t, to_jax(f), True, k) for t, f, k in bench_mix.tier_tasks(psr)]
    return tasks


PLAN_LISTS = {"mix": {"dense", "dslice"}, "breadth": {"dense", "sort", "join", "gridmix"},
              "tiers": {"dense", "direct", "sort", "join", "gridmix"}}


@pytest.mark.parametrize("lists", sorted(PLAN_LISTS))
def test_plans_match_jax(bench20k, lists):
    """The port's planner gives the JAX package's plan (tier, tree, groups,
    rows, weights, WAND bounds, dense spans, aux pairs) and skyline
    schedule for every task of the mix, the breadth categories and the
    tier batch (one list per case), each under its own knobs."""
    from iresearch_tpu.exec.skyline import skyline_spec as jax_skyline_spec
    from iresearch_tpu_torch.exec.skyline import skyline_spec

    jsr, _pdata = bench20k
    psr = carry(jsr)
    scorer = JS.BM25()
    modes = set()
    for name, flt, wand, knobs in _task_lists(psr, (lists,)):
        with both_knobs(**knobs):
            pp, jp = _plan_both(jsr, psr, flt, scorer, wand)
        _plans_equal(pp, jp, name)
        modes.add(pp.exec_mode)
        if pp.exec_mode == "dense" and not pp.groups:
            ps = skyline_spec(pp, psr, to_port(scorer), 10)
            js = jax_skyline_spec(jp, jsr, scorer, 10)
            assert (ps is None) == (js is None), name
            if js is not None:
                for f in dataclasses.fields(js):
                    _same(getattr(ps, f.name), getattr(js, f.name), f"{name} sky.{f.name}")
    assert PLAN_LISTS[lists] <= modes, modes


PHRASE_PLANS = {
    "phrase": JF.ByPhrase("body", ["t00", "t01"]),
    "gap": JF.ByPhrase("body", ["t00", (2, "t01"), "t02"]),
    "same_position": JF.BySamePosition([("body", "t00"), ("body", "t00")]),
    "and_term": JF.And(JF.ByTerm("body", "t03"), JF.ByPhrase("body", ["t01", "t02"])),
    "or_not": JF.Or(JF.ByPhrase("body", ["t00", "t00"]), JF.Not(JF.ByTerm("body", "t05"))),
    "prefix_part": JF.ByPhrase("body", ["t00", JF.PhrasePrefix("t0")]),
    "missing_term": JF.ByPhrase("body", ["t00", "nothere"]),
}


@pytest.mark.parametrize("device_phrase", [True, "keys"], ids=["device", "keys"])
@pytest.mark.parametrize("name", sorted(PHRASE_PLANS))
def test_phrase_plans_match_jax(cand_reader, name, device_phrase):
    """Plans with on-device phrase leaves: ``_make_aux``'s two phrase
    branches give the JAX package's plan, its ``device_aux`` rows (aux
    index and spec, array for array) included, and fall through to the
    host evaluation where the spec is None."""
    segs = carried(cand_reader)
    pp, jp = _plan_both(segs.jax[0], segs.port[0], PHRASE_PLANS[name], JS.BM25(),
                        False, device_phrase)
    _plans_equal(pp, jp, name)
    assert len(pp.device_aux) == len(jp.device_aux)
    on_device = name not in ("prefix_part", "missing_term") or device_phrase == "keys"
    assert bool(pp.device_aux) == on_device, name
    for (_a, ps), (_b, js) in zip(pp.device_aux, jp.device_aux):
        assert type(ps).__module__.startswith("iresearch_tpu_torch.")
        assert type(ps).__name__ == type(js).__name__


def _host_queries(psr):
    tasks = [f for _n, f, _w, _k in _task_lists(psr)]
    h, m, lo = tasks[0], tasks[80], tasks[160]
    return tasks[::7] + [
        JF.ByPhrase("body", [h.term, m.term]),
        JF.ByWildcard("body", "t00_1%"),
        JF.ByRange("body", lo.term, m.term),
        JF.Or(h, JF.Not(m), min_match=1, merge="max"),
        JF.And(h, m, merge="min"),
    ]


@pytest.mark.parametrize("scorer", [JS.BM25(), JS.TFIDF()], ids=["bm25", "tfidf"])
def test_host_query_matches_jax(bench20k, cand_reader, scorer):
    """The port's HostQuery (expansion, sampling, stats, scoring) equals
    the JAX package's bit for bit, with BM25 and TFIDF, on the bench
    segment and on a reader with deletes."""
    from iresearch_tpu.search.host_eval import HostQuery as JaxHostQuery
    from iresearch_tpu_torch.search.host_eval import HostQuery

    jsr, _pdata = bench20k
    psr = carry(jsr)
    cand = carried(cand_reader)
    T = lambda t: JF.ByTerm("body", t)  # noqa: E731
    cases = [([jsr], [psr], f) for f in _host_queries(psr)] + [
        (cand.jax, cand.port, f) for f in (
            T("t00"), JF.And(T("t01"), JF.Not(T("t00"))),
            JF.Or(T("t02"), T("t05"), min_match=2),
            JF.ByPhrase("body", ["t00", "t01"]), JF.ByEditDistance("body", "t11"),
        )
    ]
    for jsegs, psegs, flt in cases:
        want = JaxHostQuery(flt, jsegs, scorer)
        got = HostQuery(to_port(flt), psegs, to_port(scorer))
        w, g = want.execute(0), got.execute(0)
        np.testing.assert_array_equal(g.match, w.match, err_msg=repr(flt))
        np.testing.assert_array_equal(g.score, w.score, err_msg=repr(flt))
        assert got.top_k(10) == want.top_k(10)


# --- the stdlib-only utils copies ------------------------------------------


def _log_run(m):
    seen = []
    m.set_callback(lambda level, msg: seen.append((int(level), msg)))
    try:
        m.info("a %d", 1)
        m.warn("b")
        m.error("c %s %s", "x", 2)
        m.debug("d")
        m.log(m.Level.TRACE, "e %r", (1,))
    finally:
        m.set_callback(None)
    return seen, [(lv.name, int(lv)) for lv in m.Level]


def _timer_run(m):
    reg = m.TimerRegistry()
    for name in ("a", "b", "a"):
        with reg.scoped(name):
            pass
    calls = []
    reg.visit(lambda name, count, ns: calls.append((name, count)) or True)
    counts = {k: v[0] for k, v in reg.stats().items()}
    flushed = {k: v[0] for k, v in reg.flush_stats().items()}
    return sorted(calls), counts, flushed, sorted(reg.stats())


def _pools_run(m):
    made = []
    pool = m.BoundedObjectPool(lambda: made.append(1) or len(made), 2)
    a, b = pool.acquire(), pool.acquire()
    none = pool.acquire(timeout=0.01)
    pool.release(a)
    with pool.lease() as c:
        leased = c
    up = m.UnboundedObjectPool(lambda: [], max_cached=1)
    x = up.acquire()
    up.release(x)
    same = up.acquire() is x
    wg = m.WaitGroup()
    out = []
    tp = m.ThreadPool(3, name="t")
    for i in range(20):
        tp.submit(lambda i=i: out.append(i * i), wg)
    done = wg.wait(timeout=30)
    tp.stop()
    return (a, b, none, leased, len(made), same, done, sorted(out))


def _resource_run(m):
    rm = m.ResourceManager(lambda cat, cur, delta: cur + delta <= 100)
    rm.increase("pool", 60)
    try:
        rm.increase("pool", 50)
        err = None
    except m.ResourceLimitExceeded as e:
        err = (type(e).__mro__[1].__name__, str(e))
    rm.decrease("pool", 10)
    rm.increase("x", 5)
    old = m.set_manager(rm)
    now = m.manager() is rm
    m.set_manager(old)
    return err, rm.used("pool"), rm.snapshot(), now


def _metrics_run(m):
    reg = m.MetricsRegistry()
    reg.gauge("irs_g", 2.5, {"b": "1", "a": "2"}, help_="a gauge")
    reg.counter("irs_c", 2, help_="a counter")
    reg.counter("irs_c", 3, {"k": "v"})
    return reg.render(), reg.counter_value("irs_c")


@pytest.mark.parametrize("name", ["log", "timer", "pools", "resource", "metrics"])
def test_utils_copies_match_jax(name):
    """The port's copies of ``utils/{log,timer,pools,resource}.py`` and its
    ``metrics.py`` (the JAX package's push to a gateway left out) give the
    JAX package's results on the same calls."""
    import importlib

    run = globals()[f"_{name}_run"]
    got = run(importlib.import_module(f"iresearch_tpu_torch.utils.{name}"))
    want = run(importlib.import_module(f"iresearch_tpu.utils.{name}"))
    assert got == want


# --- copies of the ingest path (analysis, index lifecycle, host functions) --


def _arr(a):
    a = np.asarray(a)
    return str(a.dtype), a.shape, a.tobytes()


def _mod(root, name):
    import importlib

    return importlib.import_module(f"{root}.{name}")


def _small_index(root, sort=False):
    """A three-segment index with deletes, stored values and feature
    columns, written by package ``root``'s own writer."""
    w, F, dirs = _mod(root, "index.writer"), _mod(root, "search.filters"), _mod(root, "store.directory")
    d = dirs.MemoryDirectory()
    rng = np.random.default_rng(3)
    words = ["red", "green", "blue", "cyan", "black", "white", "gold", "plum"]
    opts = w.IndexWriterOptions(invert_backend="numpy", segment_docs_max=40)
    if sort:
        opts.sort = w.SortSpec("id")
    with w.IndexWriter(d, opts) as iw:
        for i in range(100):
            text = " ".join(words[j] for j in rng.integers(0, len(words), int(rng.integers(1, 9))))
            iw.insert([w.Field("body", text, analyzer="segmentation", feature_columns=("norm",)),
                       w.Field("id", "%03d" % (97 * i % 100), store=True)])
            if i == 60:
                iw.commit()
        iw.remove(F.ByTerm("body", "gold"))
        iw.commit()
    return d


def _analysis_run(root):
    A = _mod(root, "analysis")
    out = []
    for name, args, text in [("text", {"locale": "de"}, "Die Katzen laufen schnell"),
                             ("segmentation", {}, "Hello, Wörld! 北京大学"),
                             ("ngram", {"min": 1, "max": 3}, "abcd"),
                             ("numeric", {}, "12.5"),
                             ("pipeline", {"pipeline": [{"type": "delimiter"},
                                                        {"type": "norm"}]}, "A,b,C")]:
        out.append([(t.term, t.position, t.start, t.end) for t in A.get(name, args).tokenize(text)])
    return out


def _native_run(root):
    nat = _mod(root, "native")
    td = nat.TermDict()
    ids = [td.add(t) for t in (b"x", b"y", b"x", b"zz")]
    tids = td.tokenize_to_tids("Hello hello WORLD x", "lower", "alpha")
    other = nat.TermDict()
    for t in (b"zz", b"new", b"x"):
        other.add(t)
    remap = td.merge_from(other)
    ascii_ = nat.tokenize_ascii("Foo bar42 _baz", "upper", "all")
    crc = nat.crc32c(b"iresearch", 7)
    fp = _mod(root, "formats.segment_io").read_segment(
        _small_index(root).read("_3.seg")).fields["body"]
    dmap = np.arange(100, dtype=np.int64)[: len(fp.norms)] * 2 - 5
    cap = int(fp.entries[:, 0].astype(np.int64).sum())
    dec = nat.merge_decode(fp.entries, fp.doc_words, fp.base, fp.freq_words, dmap,
                           np.arange(fp.entries.shape[0], dtype=np.int64)[::-1].copy(), cap)
    u32 = np.arange(50, dtype=np.uint32)
    out32 = np.zeros(12, np.uint32)
    nat.copy_runs_u32(u32, np.array([3, 40], np.int64), np.array([0, 6], np.int64),
                      np.array([6, 6], np.uint32), out32)
    out8 = np.zeros(9, np.uint8)
    nat.copy_runs_bytes(np.frombuffer(b"abcdefghijkl", np.uint8), np.array([1, 8], np.int64),
                        np.array([0, 5], np.int64), np.array([5, 4], np.int64), out8)
    return (ids, len(td), td.terms(), tids.tolist(), remap.tolist(),
            None if ascii_ is None else (ascii_[0], ascii_[1].tolist()), crc,
            [_arr(a) for a in dec], out32.tolist(), out8.tobytes())


def _columnstore_run(root):
    cs = _mod(root, "formats.columnstore")
    out = []
    for docs, vals, n in [([0, 1, 2], [b"a", b"bb", b""], 3), ([1, 4, 4, 7], [b"x", b"y", b"z", b""], 9),
                          ([2, 5], [b"", b""], 6)]:
        b = cs.ColumnBuilder("c")
        for d, v in zip(docs, vals):
            b.add(d, v)
        col = b.build(n)
        dmap = np.arange(n, dtype=np.int64)[::-1].copy()
        dmap[1] = -1
        parts = cs.column_parts(col, dmap)
        back = cs.column_from_parts(*parts, n)
        rem = cs.remap_column(col, dmap, n)
        out.append([(c.kind, list(c.items())) for c in (col, back, rem)]
                   + [_arr(parts[0]), _arr(parts[1]), parts[2]])
    return out


def _host_eval_run(root):
    he, F, S = _mod(root, "search.host_eval"), _mod(root, "search.filters"), _mod(root, "search.scorers")
    r = _mod(root, "index.reader").DirectoryReader.open(_small_index(root))
    flt = F.Or(F.ByTerm("body", "red"), F.ByTerm("body", "plum"))
    return ([he.match_docs(flt, sr).tolist() for sr in r.segments],
            he.search(r, flt, S.BM25(), 7), he.search(r, F.ByTerm("body", "cyan"), None, 3))


def _scorers_run(root):
    S = _mod(root, "search.scorers")
    out = [repr(S.get_scorer(n, a)) for n, a in
           [("bm25", None), ("bm25", {"k": 2.0, "b": 0.5}), ("tfidf", {"withNorms": False}),
            ("boost", {})]]
    try:
        S.get_scorer("nope")
    except KeyError as e:
        out.append(str(e))
    return out


def _features_run(root):
    fe = _mod(root, "index.features")
    norms = np.array([0, 3, 300, 70000, 1], np.uint32)
    cols = fe.build_feature_columns("body", ["norm", "norm2"], norms, 5)
    sr = _mod(root, "index.reader").DirectoryReader.open(_small_index(root)).segments[0]
    return ([(k, c.kind, list(c.items())) for k, c in sorted(cols.items())],
            [fe.read_feature(sr, "norm", "body", d) for d in range(5)],
            fe.feature_column_name("norm2", "f"))


def _consolidate_run(root):
    co = _mod(root, "index.consolidate")
    r = _mod(root, "index.reader").DirectoryReader.open(_small_index(root))
    pols = [co.consolidate_count(), co.consolidate_count(5), co.consolidate_docs_live(0.01),
            co.consolidate_docs_fill(0.99), co.consolidate_bytes(0.9),
            co.consolidate_bytes_accum(0.9), co.consolidate_tier(), co.consolidate_tier(min_segments=2)]
    return [list(p(r)) for p in pols]


def _reader_run(root):
    rd = _mod(root, "index.reader")
    d = _small_index(root)
    r = rd.DirectoryReader.open(d, rd.ReaderOptions(read_doc_masks=False))
    m = rd.read_meta(d)
    return (m.to_bytes(), sorted(m.referenced_files()), rd.find_last_generation(d),
            r.live_docs_count, [sr.num_docs for sr in r], r.field_stats("body"),
            r.term_stats("body", b"red"), r.stored(70, "id"),
            _arr(rd._read_mask(d, m.segments[0])) if m.segments[0].del_file else None)


def _merge_run(root):
    mg, io = _mod(root, "index.merge"), _mod(root, "formats.segment_io")
    r = _mod(root, "index.reader").DirectoryReader.open(_small_index(root))
    sort = _mod(root, "index.writer").SortSpec("id", descending=True)
    merged, maps = mg.merge_segments(r.segments, sort=sort, return_doc_maps=True)
    return io.write_segment(mg.merge_segments(r.segments)), io.write_segment(merged), \
        [m.tolist() for m in maps]


def _writer_run(root):
    d = _small_index(root, sort=True)
    return sorted((n, bytes(d.read(n))) for n in d.list())


@pytest.mark.parametrize("name", ["analysis", "native", "columnstore", "host_eval", "scorers",
                                  "features", "consolidate", "reader", "merge", "writer"])
def test_ingest_copies_match_jax(name):
    """The port's copies of ``analysis``, ``index/{reader,merge,
    consolidate,features,writer}.py`` and the functions added to
    ``native.py``, ``formats/columnstore.py``, ``search/host_eval.py`` and
    ``search/scorers.py`` give the JAX package's results on the same
    calls."""
    run = globals()[f"_{name}_run"]
    assert run("iresearch_tpu_torch") == run("iresearch_tpu")
