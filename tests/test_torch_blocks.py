"""Port building blocks vs the JAX package on the CPU: unpack, scoring,
exact top-k and segment residency. Inputs come from numpy seeds and go
through both packages as numpy arrays; scorers and segments reach the
port through ``to_port`` and ``carry`` (``tests/test_torch_carry.py``)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from iresearch_tpu.formats.bitpack import BITS, pack_blocks, unpack_jnp  # noqa: E402
from iresearch_tpu.search.scorers import BM25, TFIDF, BoostScore, score_block  # noqa: E402
from iresearch_tpu_torch.formats.bitpack import unpack_torch  # noqa: E402
from iresearch_tpu_torch.ops import topk as tk  # noqa: E402
from iresearch_tpu_torch.ops.topk import topk_docs  # noqa: E402
from iresearch_tpu_torch.search.scorers import (  # noqa: E402
    score_block_torch,
    score_expr_torch,
)
from test_torch_carry import carry, jax_bench_reader, to_port  # noqa: E402

SCORERS = [BM25(), BM25(k=0.9, b=0.4), BM25(b=0.0), TFIDF(),
           TFIDF(with_norms=False), BoostScore()]
SCORER_IDS = ["bm25", "bm25_k09_b04", "bm15", "tfidf", "tfidf_nonorm", "boost"]


def _words(rng, n, b):
    """Random planar words whose lanes use every bit of the width
    (b = 32 lanes set the sign bit, the case the int32 view must keep)."""
    vals = rng.integers(0, 1 << b, size=(n, 128), dtype=np.uint64)
    return pack_blocks(vals.astype(np.uint32), b)


@pytest.mark.parametrize("b", BITS)
def test_unpack_matches_jnp(b):
    w = _words(np.random.default_rng(b), 37, b)
    want = np.asarray(unpack_jnp(jnp.asarray(w), b))
    got = unpack_torch(torch.from_numpy(w.view(np.int32)), b).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want)


def _score_inputs(seed):
    rng = np.random.default_rng(seed)
    f = rng.integers(0, 40, size=(16, 128)).astype(np.float32)
    dl = rng.integers(1, 300, size=(16, 128)).astype(np.float32)
    w = rng.uniform(0.1, 5.0, size=(16, 1)).astype(np.float32)
    return w, f, dl, np.float32(rng.uniform(20.0, 80.0))


# tolerance: the same operations in the same order on both sides; XLA may
# still contract or reassociate on the CPU, so allow 2 ulp-ish (rtol 1e-6)
@pytest.mark.parametrize("scorer", SCORERS, ids=SCORER_IDS)
def test_score_block_matches_jax(scorer):
    w, f, dl, avgdl = _score_inputs(1)
    want = np.asarray(
        score_block(scorer, jnp.asarray(w), jnp.asarray(f), jnp.asarray(dl),
                    jnp.float32(avgdl), xp=jnp)
    )
    got = score_block_torch(
        to_port(scorer), torch.from_numpy(w), torch.from_numpy(f), torch.from_numpy(dl),
        torch.tensor(avgdl),
    ).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0.0)
    assert np.all(got[f == 0] == 0.0)


@pytest.mark.parametrize("scorer", SCORERS, ids=SCORER_IDS)
def test_score_expr_matches_jax(scorer):
    from iresearch_tpu.ops.dense_scan import _score_expr

    w, f, dl, avgdl = _score_inputs(2)
    want = np.asarray(
        _score_expr(scorer, jnp.asarray(w), jnp.asarray(f), jnp.asarray(dl),
                    jnp.float32(avgdl), jnp)
    )
    got = score_expr_torch(
        to_port(scorer), torch.from_numpy(w), torch.from_numpy(f), torch.from_numpy(dl),
        float(avgdl),
    ).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0.0)


def _jax_topk_canonical(x, docs, k):
    """JAX topk_docs, reordered by (score desc, doc asc): the JAX function
    fixes only the boundary tie group, interior ties keep lane order."""
    from iresearch_tpu.exec.candidates import topk_docs as jtopk

    v, d = jtopk(jnp.asarray(x), jnp.asarray(docs), k)
    v, d = np.asarray(v), np.asarray(d)
    o = np.lexsort((d, -v))
    return v[o], d[o]


TOPK_CASES = {
    "random": (np.random.default_rng(0).normal(size=10_000).astype(np.float32), 10),
    "ties_cross_chunk": (
        np.where(np.isin(np.arange(4096), [5, 300, 1030, 2050, 4000, 6, 301, 1031]),
                 7.0, 0.0).astype(np.float32), 6),
    "neg_inf": (np.full(5000, -np.inf, np.float32), 10),
    "small": (np.arange(64, dtype=np.float32), 10),
    "four_way_tie": (np.asarray([1, 1, 1, 0.5], np.float32), 2),
    "signed_zero": (np.asarray([0.0, -0.0, 1.0, -0.0, -1.0], np.float32), 4),
}


@pytest.mark.parametrize("case", sorted(TOPK_CASES))
def test_topk_docs_by_position_matches_lax(case):
    """docs=None ranks by lane: bit-identical to lax.top_k, ties included."""
    from jax import lax

    x, k = TOPK_CASES[case]
    rv, ri = lax.top_k(jnp.asarray(x), k)
    v, i = topk_docs(torch.from_numpy(x), None, k)
    np.testing.assert_array_equal(v.numpy(), np.asarray(rv))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ri))


@pytest.mark.parametrize("case", sorted(TOPK_CASES))
def test_topk_docs_matches_jax(case):
    x, k = TOPK_CASES[case]
    docs = np.random.default_rng(3).permutation(len(x)).astype(np.int32)
    wv, wd = _jax_topk_canonical(x, docs, k)
    v, d = topk_docs(torch.from_numpy(x), torch.from_numpy(docs), k)
    np.testing.assert_array_equal(v.numpy(), wv)
    np.testing.assert_array_equal(d.numpy(), wd)


def test_topk_docs_batched_with_parked_docs():
    """[Q, n] rows, -inf lanes parked at IMAX (the dslice convention)."""
    rng = np.random.default_rng(4)
    x = rng.integers(0, 5, size=(6, 300)).astype(np.float32)
    x[x == 0] = -np.inf
    docs = np.where(np.isfinite(x), rng.permutation(300)[None, :], 2**31 - 1).astype(np.int32)
    v, d = topk_docs(torch.from_numpy(x), torch.from_numpy(docs), 10)
    for q in range(6):
        wv, wd = _jax_topk_canonical(x[q], docs[q], 10)
        np.testing.assert_array_equal(v[q].numpy(), wv)
        np.testing.assert_array_equal(d[q].numpy(), wd)


def _tiled_select(calls):
    """A stand-in for one K4 launch (``ops/topk.py:_select``) on the CPU:
    each tile's top k by the plain version, written where the kernel writes
    it, in reverse order where the kernel leaves them unsorted; records
    (n, tiles, k) and checks the tile bounds K4 relies on."""

    def select(scores, docs, tiles, k, vals, out):
        q, n = scores.shape
        calls.append((n, tiles, k))
        for t in range(tiles):
            a, b = t * n // tiles, (t + 1) * n // tiles
            assert k <= b - a <= tk._tile_cap(k)
            d = (torch.arange(a, b, dtype=torch.int32).expand(q, b - a)
                 if docs is None else docs[:, a:b])
            v, dd = tk.topk_docs_ref(scores[:, a:b], d, k)
            if tiles > 1 or k > tk.K4_MAX_K:
                v, dd = v.flip(-1), dd.flip(-1)
            vals[:, t * k:(t + 1) * k] = v
            out[:, t * k:(t + 1) * k] = dd

    return select


def _sorting(calls):
    """A stand-in for K4's sort (``ops/topk.py:_sort``) on the CPU: the
    plain version over the unsorted winners; records ("sort", launches)."""

    def sort(vals, docs, out_vals, out_docs):
        assert vals.shape[1] > tk.K4_MAX_K and vals.is_contiguous() and docs.is_contiguous()
        calls.append(("sort", tk._sort_launches(vals.shape[1])))
        v, d = tk.topk_docs_ref(vals, docs, vals.shape[1])
        out_vals.copy_(v)
        out_docs.copy_(d)

    return sort


def _topk_docs_arg(rng, form, shape):
    n = shape[-1]
    if form is None:
        return None
    if form == "expanded":
        return torch.arange(n, dtype=torch.int32).expand(shape)
    if form == "strided":
        wide = rng.permutation(2 * n).astype(np.int32)
        return torch.from_numpy(np.broadcast_to(wide, shape[:-1] + (2 * n,)).copy())[..., ::2]
    dtype = {"int32": np.int32, "int64": np.int64}[form]
    return torch.from_numpy(rng.permutation(n).astype(dtype) + (2**35 if form == "int64" else 0)
                            ).expand(shape).contiguous()


# (shape, k, docs form, K4 launches): several launches where a row is
# wider than one tile; above K4_MAX_K the sort's launches besides
TOPK_ROUTES = {
    "one_tile": ((5, 4000), 100, "int32", 1),
    "k_eq_n": ((3, 500), 500, None, 1),
    "two_launches": ((3, 70_000), 100, None, 2),
    "three_launches": ((1, 2**21), 100, None, 3),
    "ragged_tiles": ((2, 3 * 8192 + 7), 50, "strided", 2),
    "expanded": ((4, 20_000), 200, "expanded", 2),
    "lead_dims": ((2, 3, 20_000), 10, "int32", 2),
    "k4096": ((2, 40_000), 4096, "int64", 2),
    "k4097": ((2, 40_000), 4097, "int64", 4),
    "k9000_two_levels": ((1, 100_000), 9000, None, 5),
    "k_eq_n_above_max": ((3, 5000), 5000, "int32", 3),
}


@pytest.mark.parametrize("case", sorted(TOPK_ROUTES))
def test_topk_docs_kernel_route_matches_plain(monkeypatch, case):
    """The wrapper's CUDA route on the CPU, each K4 launch stood in for by
    the plain version per tile: the launches ``_plan`` asks for, and above
    ``K4_MAX_K`` the sort's, give the plain result; docs of every form, and
    positions (int32) where there are none."""
    shape, k, form, launches = TOPK_ROUTES[case]
    rng = np.random.default_rng(len(case))
    x = rng.normal(size=shape).astype(np.float32)
    x[rng.random(shape) < 0.3] = -np.inf
    x[..., :7] = 1.5  # a tie across the first tile
    scores, docs = torch.from_numpy(x), _topk_docs_arg(rng, form, shape)
    calls = []
    monkeypatch.setattr(tk, "runs_plain", lambda t: False)
    monkeypatch.setattr(tk, "_select", _tiled_select(calls))
    monkeypatch.setattr(tk, "_sort", _sorting(calls))
    v, d = topk_docs(scores, docs, k)
    selects = [c for c in calls if c[0] != "sort"]
    assert [t for _n, t, _k in selects] == tk._plan(shape[-1], k)
    sorts = [c[1] for c in calls if c[0] == "sort"]
    assert sorts == ([tk._sort_launches(k)] if k > tk.K4_MAX_K else [])
    assert len(selects) + sum(sorts) == launches == tk.launches(shape[-1], k)
    wv, wd = tk.topk_docs_ref(scores, docs, k)
    assert v.shape == wv.shape == shape[:-1] + (k,) and d.dtype == wd.dtype
    assert torch.equal(v.view(torch.int32), wv.view(torch.int32))
    assert torch.equal(d, wd)


def _bad_topk(kind):
    x = torch.zeros((2, 50))
    return {
        "f64": (x.double(), None, 5, TypeError),
        "docs_shape": (x, torch.zeros((2, 49), dtype=torch.int32), 5, ValueError),
        "k0": (x, None, 0, ValueError),
        "k_above_n": (x, None, 51, ValueError),
    }[kind]


@pytest.mark.parametrize("route", ["plain", "kernel"])
@pytest.mark.parametrize("kind", ["f64", "docs_shape", "k0", "k_above_n"])
def test_topk_docs_checks_on_both_routes(monkeypatch, route, kind):
    """Both routes raise the same errors before any launch."""
    scores, docs, k, err = _bad_topk(kind)
    if route == "kernel":
        monkeypatch.setattr(tk, "runs_plain", lambda t: False)
        monkeypatch.setattr(tk, "_select", lambda *a: pytest.fail("launched"))
        monkeypatch.setattr(tk, "_sort", lambda *a: pytest.fail("launched"))
    with pytest.raises(err):
        topk_docs(scores, docs, k)


def test_topk_docs_kernel_route_takes_int32_or_int64_docs(monkeypatch):
    monkeypatch.setattr(tk, "runs_plain", lambda t: False)
    monkeypatch.setattr(tk, "_select", lambda *a: pytest.fail("launched"))
    with pytest.raises(TypeError, match="int32 or int64"):
        topk_docs(torch.zeros((2, 50)), torch.zeros((2, 50), dtype=torch.int16), 5)


@pytest.mark.parametrize("k", [1, 100, 200, 2048, 2049, 4096, 4097, 30_000])
def test_topk_plan_shrinks_rows_within_tiles(k):
    """Every launch of ``_plan`` cuts rows into tiles of 2k..cap entries
    (so each tile keeps k and a row at least halves), the last one tile."""
    for n in (k, 4 * k, 8192, 8193, 25_600, 15_625, 2**21 + 3, 10**7):
        if n < k:
            continue
        plan = tk._plan(n, k)
        assert plan[-1] == 1
        width = n
        for tiles in plan:
            assert -(-width // tiles) <= tk._tile_cap(k)
            assert tiles == 1 or width // tiles >= 2 * k
            width = tiles * k


@pytest.fixture(scope="module")
def small_reader():
    sr = jax_bench_reader("blocks", 20_000)
    return sr, carry(sr)


def _np(t):
    return t.numpy()


def test_device_state_matches_jax_device_field(small_reader):
    """Every array of the port's residency equals the JAX DeviceField's
    bit for bit (u32 words compared through their int32 view); the port's
    dense grid is its own build, from its carried reader."""
    from iresearch_tpu_torch.index.segment import device_state

    sr, psr = small_reader
    jf = sr.device_field("body")
    st = device_state(psr, torch.device("cpu"))
    tf = st.field("body")
    assert device_state(psr, "cpu") is st

    def same(t, a):
        a = np.asarray(a)
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        got = _np(t)
        assert got.dtype == a.dtype and got.shape == a.shape
        np.testing.assert_array_equal(got, a)

    for name in ("doc_words", "freq_words", "nrm_words", "base", "bmax", "bmaxf"):
        for t, a in zip(getattr(tf, name), getattr(jf, name)):
            same(t, a)
    same(tf.norms, jf.norms)
    same(tf.norms_u16, jf.norms_u16)
    same(tf.norms_grid(), jf.norms_grid())
    cache, pcache = sr.dense_cache("body"), psr.dense_cache("body")
    assert cache is not None
    for c, pool in enumerate(cache.pools):
        same(tf.dense_words(pcache, c), jf.dense_words(cache, c))
    same(st.alive, sr.device().alive)
    assert tf.avgdl == jf.avgdl


def test_dl_rows_widens_u16_exactly():
    from iresearch_tpu_torch.index.segment import dl_rows

    n = np.asarray([[1, 255, 256, 32767], [32768, 40000, 65535, 7]], np.uint16)
    t = torch.from_numpy(n)
    np.testing.assert_array_equal(dl_rows(t).numpy(), n.astype(np.float32))
    rows = torch.tensor([1, 0, 1])
    np.testing.assert_array_equal(dl_rows(t, rows).numpy(), n[[1, 0, 1]].astype(np.float32))


def _stream(seed, num_docs, vocab, avg_len=30):
    """``tests/test_postings.py``'s random corpus, vectorised: a token
    stream in (doc asc, pos asc) arrival order."""
    rng = np.random.default_rng(seed)
    lens = rng.poisson(avg_len, size=num_docs)
    doc = np.repeat(np.arange(num_docs), lens)
    pos = (np.arange(len(doc)) - np.repeat(np.cumsum(lens) - lens, lens)).astype(np.uint32)
    return rng.integers(0, vocab, size=len(doc)), doc, pos


INVERT_CASES = {
    # tests/test_postings.py::TestInvert: the two corpora it inverts
    "postings_200x50": lambda: _stream(0, 200, 50) + (50, 200),
    "postings_97x31": lambda: _stream(1, 97, 31) + (31, 97),
    "empty": lambda: (np.zeros(0), np.zeros(0), np.zeros(0, np.uint32), 5, 10),
    "one_token": lambda: (np.array([3]), np.array([7]), np.array([0], np.uint32), 5, 10),
    # one term everywhere, positions past 2^31 (the u32 view must survive)
    "one_term_big_pos": lambda: (
        np.zeros(300, np.int64), np.repeat(np.arange(100), 3),
        (np.tile(np.arange(3), 100) + 2**31 + 5).astype(np.uint32), 4, 130),
}


@pytest.mark.parametrize("case", sorted(INVERT_CASES))
def test_invert_device_matches_numpy_and_jax(case):
    """``invert_device(device="cpu")`` equals the port's ``invert_numpy``
    field by field and bit for bit (dtypes too), and the JAX package's
    ``invert_device`` and ``invert_numpy``."""
    import dataclasses

    from iresearch_tpu.index import invert as jinv
    from iresearch_tpu_torch.index.invert import invert_device, invert_numpy

    tid, doc, pos, num_terms, num_docs = INVERT_CASES[case]()
    got = invert_device(tid, doc, pos, num_terms, num_docs, device="cpu")
    refs = {
        "invert_numpy": invert_numpy(tid, doc, pos, num_terms, num_docs),
        "jax invert_numpy": jinv.invert_numpy(tid, doc, pos, num_terms, num_docs),
        "jax invert_device": jinv.invert_device(tid, doc, pos, num_terms, num_docs),
    }
    for what, want in refs.items():
        for f in dataclasses.fields(want):
            a, b = getattr(got, f.name), getattr(want, f.name)
            assert a.dtype == b.dtype and a.shape == b.shape, (what, f.name, a.dtype, b.dtype)
            np.testing.assert_array_equal(a, b, err_msg=f"{what}.{f.name}")
    if len(tid):
        np.testing.assert_array_equal(got.pos_flat, np.asarray(pos)[got.order])
        assert int(got.e_freq.sum()) == len(tid)
