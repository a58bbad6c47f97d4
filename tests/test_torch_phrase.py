"""The port's on-device phrase (``exec/phrase.py``) vs the JAX package on
the CPU.

One seeded reader (400 docs, ``body`` and ``title`` with positions, one doc
deleted) is written by the JAX package and carried to the
port through the segment file (``carry``); filters and scorers go through
``to_port``. Held against each other on the same inputs:

* ``compile_phrase`` / ``compile_phrase_keys``: the specs, array for array;
* ``run_phrase_dense``: match equal, scores to rtol 1e-5 (the same
  operations; XLA may reorder the scatter-add's float adds, which cannot
  change whole-number counts);
* ``DeviceQuery`` with its default ``device_phrase=True`` against the JAX
  ``DeviceQuery`` default and against ``HostQuery``: the exactness gate
  (scores rtol 1e-5, docs equal except inside near-ties);
* the four cases where ``compile_phrase`` returns ``None`` and the host
  evaluates the leaf.

On CPU tensors the part decode takes K3's plain version; the card runs the
kernel (``tests/test_torch_kernels.py``, ``chip_smoke.py`` phase 9).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from iresearch_tpu.exec import phrase as jph  # noqa: E402
from iresearch_tpu.index.reader import DirectoryReader  # noqa: E402
from iresearch_tpu.index.writer import Field, IndexWriter, IndexWriterOptions  # noqa: E402
from iresearch_tpu.search import filters as F  # noqa: E402
from iresearch_tpu.search.host_eval import HostQuery as JaxHostQuery  # noqa: E402
from iresearch_tpu.search.scorers import BM25, TFIDF  # noqa: E402
from iresearch_tpu.store.directory import MemoryDirectory  # noqa: E402
from iresearch_tpu_torch.exec import executor as tex  # noqa: E402
from iresearch_tpu_torch.exec import phrase as tph  # noqa: E402
from iresearch_tpu_torch.search.host_eval import HostQuery  # noqa: E402
from test_torch_carry import carried, to_port  # noqa: E402
from test_torch_exec import assert_topk_near  # noqa: E402

CPU = torch.device("cpu")
WORDS = ["red", "fox", "ran", "far", "dog", "sat", "mat", "cat"]
SCORERS = [BM25(), TFIDF()]
SCORER_IDS = ["bm25", "tfidf"]


@pytest.fixture(scope="module")
def segs():
    rng = np.random.default_rng(17)
    d = MemoryDirectory()
    with IndexWriter(d, IndexWriterOptions(invert_backend="numpy")) as w:
        for i in range(400):
            def text(lo, hi):
                n = int(rng.integers(lo, hi))
                return " ".join(WORDS[j] for j in rng.integers(0, len(WORDS), n))

            w.insert([
                Field("body", text(3, 25), analyzer="segmentation"),
                Field("title", text(2, 9), analyzer="segmentation"),
                Field("id", str(i), index=True, store=True),
            ])
        w.commit()
        w.remove(F.ByTerm("id", "11"))
        w.commit()
    out = carried(DirectoryReader.open(d))
    assert len(out.jax) == 1 and out.port[0].has_deletes
    return out


# tests/test_device_phrase.py's PHRASES, plus gaps and BySamePosition
PHRASES = {
    "two": F.ByPhrase("body", ["red", "fox"]),
    "three": F.ByPhrase("body", ["fox", "ran", "far"]),
    "repeat": F.ByPhrase("body", ["dog", "dog"]),
    "three_b": F.ByPhrase("body", ["cat", "sat", "mat"]),
    "gap": F.ByPhrase("body", ["red", (2, "ran")]),
    "gap3": F.ByPhrase("body", ["fox", "ran", (3, "dog")]),
    "boosted": F.ByPhrase("title", ["sat", "mat"], boost=2.5),
    "same_pos": F.BySamePosition([("body", "red"), ("title", "red")]),
    "same_pos_one_field": F.BySamePosition([("body", "dog"), ("body", "dog")]),
}
# queries around a phrase leaf: the aux row in the fold
TREES = {
    "missing": F.ByPhrase("body", ["red", "nothere"]),
    "and": F.And(F.ByPhrase("body", ["red", "fox"]), F.ByTerm("body", "dog")),
    "or": F.Or(F.ByPhrase("body", ["red", "fox"]), F.ByPhrase("body", ["dog", "sat"])),
    "not": F.And(F.ByTerm("body", "cat"), F.Not(F.ByPhrase("body", ["red", "fox"]))),
    "or_host_aux": F.Or(F.ByPhrase("body", ["red", "fox"]),
                        F.ByPhrase("body", ["ran", F.PhrasePrefix("fa")])),
}


def _specs(segs, flt, scorer, compile_name="compile_phrase"):
    """(port spec, JAX spec) of one phrase leaf on segment 0."""
    pflt, pscorer = to_port(flt), to_port(scorer)
    js = getattr(jph, compile_name)(
        flt, segs.jax[0], 0, 1.0, JaxHostQuery(flt, segs.jax, scorer), scorer)
    ps = getattr(tph, compile_name)(
        pflt, segs.port[0], 0, 1.0, HostQuery(pflt, segs.port, pscorer), pscorer)
    return ps, js


def _same_spec(ps, js):
    assert type(ps).__name__ == type(js).__name__
    for f in dataclasses.fields(js):
        a, b = getattr(ps, f.name), getattr(js, f.name)
        if f.name == "parts":
            assert len(a) == len(b)
            for x, y in zip(a, b):
                _same_spec(x, y)
        elif f.name == "part_keys64":
            assert len(a) == len(b)
            for x, y in zip(a, b):
                assert x.dtype == y.dtype
                np.testing.assert_array_equal(x, y)
        elif isinstance(b, np.ndarray):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b, f.name


@pytest.mark.parametrize("scorer", SCORERS, ids=SCORER_IDS)
@pytest.mark.parametrize("name", sorted(PHRASES))
def test_run_phrase_dense_matches_jax(segs, name, scorer):
    flt = PHRASES[name]
    ps, js = _specs(segs, flt, scorer)
    assert js is not None
    _same_spec(ps, js)
    nd_pad = tex.DeviceQuery(to_port(flt), segs.port, to_port(scorer),
                             device=CPU).plan(0).nd_pad
    wm, ws = (np.asarray(x) for x in jph.run_phrase_dense(js, segs.jax[0], scorer, nd_pad))
    gm, gs = tph.run_phrase_dense(ps, segs.port[0], to_port(scorer), nd_pad, device=CPU)
    assert gm.dtype == torch.bool and gs.dtype == torch.float32
    assert gm.shape == gs.shape == (nd_pad,)
    np.testing.assert_array_equal(gm.numpy(), wm)
    assert wm.any()
    np.testing.assert_allclose(gs.numpy(), ws, rtol=1e-5, atol=0.0)
    pm, psc = tph.run_phrase_dense(ps, segs.port[0], to_port(scorer), nd_pad,
                                   device=CPU, kern=tex.PLAIN)
    assert torch.equal(pm, gm) and torch.equal(psc, gs)


def _full_k(flt, segs, scorer, nd_pad):
    hr = JaxHostQuery(flt, segs.jax, scorer).execute(0)
    return hr, min(nd_pad, max(16, int(hr.match.sum()) + 4))


@pytest.mark.parametrize("scorer", SCORERS, ids=SCORER_IDS)
@pytest.mark.parametrize("name", sorted(PHRASES) + sorted(TREES))
def test_device_query_default_matches_jax_and_host(segs, name, scorer):
    """``DeviceQuery`` as a user calls it (``device_phrase=True``) returns
    the JAX package's top-k and the oracle's match set and scores."""
    from iresearch_tpu.exec import DeviceQuery as JaxDeviceQuery

    flt = {**PHRASES, **TREES}[name]
    jq = JaxDeviceQuery(flt, segs.jax, scorer)
    tq = tex.DeviceQuery(to_port(flt), segs.port, to_port(scorer), device=CPU)
    plan = tq.plan(0)
    assert [a for a, _s in plan.device_aux] == [a for a, _s in jq.plan(0).device_aux]
    assert bool(plan.device_aux) == (name != "missing")
    hr, k = _full_k(flt, segs, scorer, plan.nd_pad)
    got = tq.execute_segment(0, k)
    assert_topk_near(got, jq.execute_segment(0, k))
    fin = np.isfinite(got[0])
    assert set(got[1][fin].tolist()) == set(np.flatnonzero(hr.match).tolist())
    np.testing.assert_allclose(got[0][fin], hr.score[got[1][fin]], rtol=1e-5, atol=1e-6)
    # the host evaluation of the same leaf, and the port's own oracle
    hq = tex.DeviceQuery(to_port(flt), segs.port, to_port(scorer),
                         device_phrase=False, device=CPU)
    assert not hq.plan(0).device_aux
    assert_topk_near(got, hq.execute_segment(0, k))
    pr = HostQuery(to_port(flt), segs.port, to_port(scorer)).execute(0)
    np.testing.assert_array_equal(pr.match, hr.match)


NONE_CASES = {
    "not_a_plain_term": F.ByPhrase("body", ["ran", F.PhrasePrefix("fa")]),
    "field_without_positions": F.BySamePosition([("body", "red"), ("title", "red")]),
    "missing_term": F.ByPhrase("body", ["red", "nothere"]),
}


def _drop_title_positions(segs, monkeypatch):
    for sr in (segs.jax[0], segs.port[0]):
        monkeypatch.setattr(sr.field("title"), "pos_words", None)
        assert not sr.field("title").has_positions


@pytest.mark.parametrize("name", sorted(NONE_CASES) + ["key_overflow"])
def test_compile_phrase_none_runs_on_host(segs, name, monkeypatch):
    """Each case where ``compile_phrase`` declines: both packages return
    None, the plan has no ``device_aux`` and the query equals the host
    path. ``field_without_positions``: the title's position pools taken
    away (the writer always records them). ``key_overflow``: one doc
    length of 2^21 in a 512-doc segment puts nd_pad * pos_cap at 2^31."""
    scorer = BM25()
    if name == "field_without_positions":
        _drop_title_positions(segs, monkeypatch)
    if name == "key_overflow":
        flt = PHRASES["two"]
        for sr in (segs.jax[0], segs.port[0]):
            fp = sr.field("body")
            norms = np.array(fp.norms)
            norms[0] = 1 << 21
            monkeypatch.setattr(fp, "norms", norms)
    else:
        flt = NONE_CASES[name]
    ps, js = _specs(segs, flt, scorer)
    assert ps is None and js is None
    tq = tex.DeviceQuery(to_port(flt), segs.port, to_port(scorer), device=CPU)
    assert not tq.plan(0).device_aux
    pr = HostQuery(to_port(flt), segs.port, to_port(scorer)).execute(0)
    k = min(tq.plan(0).nd_pad, max(16, int(pr.match.sum()) + 4))
    vals, docs = tq.execute_segment(0, k)
    fin = np.isfinite(vals)
    assert set(docs[fin].tolist()) == set(np.flatnonzero(pr.match).tolist())
    np.testing.assert_allclose(vals[fin], pr.score[docs[fin]], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", ["two", "gap3", "same_pos", "missing", "or_host_aux_part",
                                  "field_without_positions"])
def test_compile_phrase_keys_matches_jax(segs, name, monkeypatch):
    """The ``"keys"`` form (the sharded executor's): sorted int64 keys per
    part, weight, avgdl and max_pos equal to the JAX package's."""
    if name == "field_without_positions":
        _drop_title_positions(segs, monkeypatch)
    flt = {**PHRASES, **TREES, **NONE_CASES,
           "or_host_aux_part": NONE_CASES["not_a_plain_term"]}[name]
    ps, js = _specs(segs, flt, TFIDF(), "compile_phrase_keys")
    assert (ps is None) == (js is None) == (name == "field_without_positions")
    if js is not None:
        _same_spec(ps, js)
        assert all(k.dtype == np.int64 for k in ps.part_keys64)
        pp = tex.DeviceQuery(to_port(flt), segs.port, to_port(TFIDF()), device=CPU)
        plan = pp.compiler.compile(pp.flt, 0, device_phrase="keys")
        assert [type(s).__name__ for _a, s in plan.device_aux] == ["PhraseKeysSpec"]


def test_pos_words_match_jax_device_field(segs):
    """The position pools on the device: the JAX DeviceField's arrays as
    int32 bit-views, uploaded on first use and counted in device_bytes."""
    from iresearch_tpu_torch.index.segment import device_state

    jf = segs.jax[0].device_field("body")
    tf = device_state(segs.port[0], CPU).field("body")
    fp = segs.port[0].field("body")
    used = [c for c in range(len(fp.pos_words)) if fp.pos_words[c].shape[0] > 1]
    assert used
    for c in used:
        before = tf.device_bytes if c not in tf._pos_words else None
        t = tf.pos_words(c)
        want = np.asarray(jf.pos_words(c))
        assert t.dtype == torch.int32 and tuple(t.shape) == want.shape
        np.testing.assert_array_equal(t.numpy().view(np.uint32), want)
        assert tf.pos_words(c) is t
        if before is not None:
            assert tf.device_bytes == before + t.nbytes
