"""The kernels' plain PyTorch versions vs the JAX package's Pallas
kernels (interpret mode on the CPU) and XLA twins, K3's scored form vs
the composition it replaced, and the kernels themselves vs their plain
versions on the card (``cuda`` marker). Scorers
are built with the JAX package and handed to the port through
``to_port``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from iresearch_tpu.search.scorers import BM25, TFIDF, BoostScore  # noqa: E402
from iresearch_tpu_torch.formats.bitpack import BITS, pack_blocks  # noqa: E402
from iresearch_tpu_torch.formats.spec import BLOCK  # noqa: E402
from iresearch_tpu_torch.ops import decode as dc  # noqa: E402
from iresearch_tpu_torch.ops import dense_scan as ds  # noqa: E402
from iresearch_tpu_torch.ops import dma_gather as dg  # noqa: E402
from test_torch_carry import to_port  # noqa: E402

NDROWS = 64
Q = 3
MODES = {"or": (False, 1), "and": (True, 1), "mm2": (False, 2)}


def _t(a):
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


def _k1_inputs(seed, span_bits, nrows=2 * NDROWS):
    """Pools of nrows grid rows per span (a quarter of the rows empty, half
    the lanes zero so hit counts vary), per-query starts and weights."""
    rng = np.random.default_rng(seed)
    pools = []
    for b in span_bits:
        f = rng.integers(0, 1 << min(b, 6), size=(nrows, BLOCK)).astype(np.uint32)
        f[rng.random(f.shape) < 0.5] = 0
        f[rng.integers(0, nrows, size=nrows // 4)] = 0
        pools.append(pack_blocks(f, b))
    starts = rng.integers(0, nrows - NDROWS + 1, size=(Q, len(span_bits))).astype(np.int32)
    ws = rng.uniform(0.5, 3.0, size=(Q, len(span_bits))).astype(np.float32)
    norms = rng.integers(1, 90, size=(NDROWS, BLOCK)).astype(np.float32)
    return pools, starts, ws, norms, 47.3


def _k1_port(pools, starts, ws, norms, avgdl, *, scorer, **kw):
    m, a = ds.dense_scan_rowmax(
        [_t(p) for p in pools], _t(starts), _t(ws), _t(norms), avgdl,
        scorer=to_port(scorer), **kw
    )
    return m.numpy(), a.numpy()


def _check_rowmax(got, want_max, want_arg, rtol):
    gm, ga = got
    want_max, want_arg = np.asarray(want_max), np.asarray(want_arg)
    fin = np.isfinite(want_max)
    np.testing.assert_array_equal(np.isfinite(gm), fin)
    np.testing.assert_allclose(gm[fin], want_max[fin], rtol=rtol, atol=0.0)
    same = fin & (gm == want_max)  # the first max lane is defined by ==
    np.testing.assert_array_equal(ga[same], want_arg[same])


# tolerance: BM25/boost keep the reference's operation order (rtol 1e-6
# allows XLA's CPU reassociation); TFIDF's rsqrt may differ by an ulp
@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("span_bits", [(4,), (8, 4), (2, 8, 16)])
@pytest.mark.parametrize("scorer", [BM25(), TFIDF(), BoostScore()], ids=["bm25", "tfidf", "boost"])
def test_rowmax_plain_matches_xla_twin(scorer, span_bits, mode):
    """K1 plain (batched, per-query starts, u16 and f32 norms) vs
    ``dense_scan_rowmax_xla`` on each query's pre-sliced rows."""
    from iresearch_tpu.ops.dense_scan import dense_scan_rowmax_xla

    conj, mm = MODES[mode]
    pools, starts, ws, norms, avgdl = _k1_inputs(11, span_bits)
    kw = dict(scorer=scorer, span_bits=span_bits, conj=conj, mm=mm)
    for nrm in (norms, norms.astype(np.uint16)):
        got = _k1_port(pools, starts, ws, nrm, avgdl, **kw)
        for q in range(Q):
            words = tuple(
                jnp.asarray(p[starts[q, s] : starts[q, s] + NDROWS])
                for s, p in enumerate(pools)
            )
            wm, wa = dense_scan_rowmax_xla(
                words, tuple(jnp.float32(w) for w in ws[q]), jnp.asarray(nrm),
                jnp.float32(avgdl), **kw,
            )
            _check_rowmax((got[0][q], got[1][q]), wm, wa, rtol=1e-6)


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("span_bits", [(4,), (8, 4), (2, 8, 16)])
def test_rowmax_plain_matches_pallas_interpret(span_bits, mode):
    """K1 plain vs the Pallas kernel ``dense_scan_rowmax`` (interpret)."""
    from iresearch_tpu.ops.dense_scan import dense_scan_rowmax

    conj, mm = MODES[mode]
    pools, starts, ws, norms, avgdl = _k1_inputs(12, span_bits)
    kw = dict(scorer=BM25(), span_bits=span_bits, conj=conj, mm=mm)
    got = _k1_port(pools, starts, ws, norms, avgdl, **kw)
    q = Q - 1
    words = tuple(
        jnp.asarray(p[starts[q, s] : starts[q, s] + NDROWS])
        for s, p in enumerate(pools)
    )
    wm, wa = dense_scan_rowmax(
        words, tuple(jnp.float32(w) for w in ws[q]), jnp.asarray(norms),
        jnp.float32(avgdl), interpret=True, **kw,
    )
    _check_rowmax((got[0][q], got[1][q]), wm, wa, rtol=1e-6)


def test_score_rows_matches_jax_rescore():
    """The scan tier's rescore vs ``_score_rows`` on the same rows."""
    from iresearch_tpu.ops.dense_scan import _score_rows

    span_bits = (8, 4)
    pools, starts, ws, norms, avgdl = _k1_inputs(13, span_bits)
    rows = np.random.default_rng(13).integers(0, NDROWS, size=(Q, 16)).astype(np.int32)
    got = ds.score_rows(
        [_t(p) for p in pools], _t(starts), _t(ws), _t(norms.astype(np.uint16)),
        torch.tensor(np.float32(avgdl)), _t(rows), scorer=to_port(BM25()),
        span_bits=span_bits,
    ).numpy()
    for q in range(Q):
        words = tuple(
            jnp.asarray(p[starts[q, s] : starts[q, s] + NDROWS])
            for s, p in enumerate(pools)
        )
        want = np.asarray(_score_rows(
            words, tuple(jnp.float32(w) for w in ws[q]), span_bits,
            jnp.asarray(norms[rows[q]]), jnp.float32(avgdl), jnp.asarray(rows[q]),
            BM25(),
        ))
        np.testing.assert_allclose(got[q], want, rtol=1e-6, atol=0.0)


def test_row_slices_plain_matches_pallas_interpret():
    """K2 plain vs ``dma_row_slices`` (interpret) with in-bounds starts,
    pools of four widths including a one-word ``base`` pool."""
    from iresearch_tpu.ops.dma_gather import dma_row_slices

    rng = np.random.default_rng(21)
    widths, rows, R = (64, 4, 32, 1), 200, 16
    pools = [rng.integers(0, 2**32, size=(rows, w), dtype=np.uint64).astype(np.uint32)
             for w in widths]
    starts = rng.integers(0, rows - R + 1, size=(5, len(widths))).astype(np.int32)
    want = dma_row_slices(tuple(jnp.asarray(p) for p in pools), jnp.asarray(starts),
                          R=R, interpret=True)
    got = dg.dma_row_slices([_t(p) for p in pools], _t(starts), R)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy().view(np.uint32), np.asarray(w))


def test_row_slices_plain_never_clamps():
    """A window past a pool's end raises (no XLA-style clamping)."""
    pool = torch.zeros((10, 4), dtype=torch.int32)
    with pytest.raises(IndexError):
        dg.dma_row_slices([pool], torch.tensor([[8]], dtype=torch.int32), 4)


@pytest.mark.parametrize("bd,bf", [(8, 2), (16, 1), (4, 4), (32, 8), (1, 1)])
def test_decode_plain_matches_pallas_interpret(bd, bf):
    """K3 plain vs ``decode_rows_pallas`` (interpret)."""
    from iresearch_tpu.ops.decode import decode_rows_pallas

    rng = np.random.default_rng(bd * 100 + bf)
    rows = 32
    deltas = rng.integers(0, 1 << min(bd, 30), size=(rows, BLOCK), dtype=np.uint64).astype(np.uint32)
    freqs = rng.integers(0, 1 << min(bf, 30), size=(rows, BLOCK), dtype=np.uint64).astype(np.uint32)
    base = rng.integers(0, 1000, rows).astype(np.int32)
    dw, fw = pack_blocks(deltas, bd), pack_blocks(freqs, bf)
    rd = rng.integers(0, rows, 16).astype(np.int32)
    rf = rng.integers(0, rows, 16).astype(np.int32)
    wd, wf = decode_rows_pallas(
        jnp.asarray(dw), jnp.asarray(fw), jnp.asarray(base), jnp.asarray(rd),
        jnp.asarray(rf), bd=bd, bf=bf, interpret=True,
    )
    gd, gf = dc.decode_rows(_t(dw), _t(fw), _t(base), _t(rd), _t(rf), bd=bd, bf=bf)
    np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))
    np.testing.assert_array_equal(gf.numpy(), np.asarray(wf))


def k3_inputs(seed, bd, bf, bn, *, rows=40, R=24, base_hi=1000):
    """Seeded K3 inputs as numpy: doc/freq/norm pools of ``rows`` blocks
    (row 0 the all-zero sentinel), bases, R row ids per pool with repeats
    and the sentinel among them, one weight per output row, and f32 norms
    covering every doc that can decode (for ``bn == -1``)."""
    rng = np.random.default_rng(seed)

    def lanes(b, cap):
        x = rng.integers(0, 1 << min(b, cap), size=(rows, BLOCK), dtype=np.uint64)
        x[0] = 0
        return x.astype(np.uint32)

    deltas, freqs = lanes(bd, 12), lanes(bf, 6)
    freqs[rng.random(freqs.shape) < 0.3] = 0
    base = rng.integers(0, base_hi, rows).astype(np.int32)
    base[0] = 0
    r = {
        "doc_words": pack_blocks(deltas, bd), "freq_words": pack_blocks(freqs, bf),
        "base": base, "w": rng.uniform(0.5, 3.0, R).astype(np.float32),
        "norms": rng.integers(1, 300, base_hi + BLOCK * (1 << min(bd, 12))).astype(np.float32),
    }
    for name in ("rows_d", "rows_f", "rows_n"):
        ids = rng.integers(0, rows, R).astype(np.int32)
        ids[R // 2] = 0  # the sentinel
        ids[-1] = ids[0]  # a repeated row
        r[name] = ids
    r["nrm_words"] = pack_blocks(lanes(max(bn, 1), 9), max(bn, 1))
    return r


def k3_args(r, bn, to=lambda t: t):
    """``decode_score_rows``'s positional arguments up to ``w``, as tensors."""
    t = {k: to(_t(v)) for k, v in r.items()}
    return (t["doc_words"], t["freq_words"], t["base"], t["rows_d"], t["rows_f"],
            t["nrm_words"] if bn >= 0 else None, t["rows_n"],
            None if bn >= 0 else t["norms"], t["w"])


K3_SCORERS = {
    "bm25": BM25(), "bm25_k09_b04": BM25(k=0.9, b=0.4), "bm15": BM25(b=0.0),
    "tfidf": TFIDF(), "tfidf_nonorm": TFIDF(with_norms=False), "boost": BoostScore(),
}


def _old_composition(a, avgdl, *, bd, bf, bn, scorer):
    """What ``group_contrib`` ran before the scored form: K3's plain
    version, then the norm unpack or gather, the clamp, the scorer and
    ``f > 0`` as separate PyTorch operations."""
    from iresearch_tpu_torch.formats.bitpack import unpack_torch
    from iresearch_tpu_torch.search.scorers import score_block_torch

    dw, fw, base, rd, rf, nw, rn, norms, w = a
    docs, f = dc.decode_rows_ref(dw, fw, base, rd, rf, bd=bd, bf=bf)
    if bn >= 0:
        dl = torch.clamp_min(unpack_torch(nw[rn.to(torch.int64)], bn).to(torch.float32), 1.0)
    else:
        dl = norms[torch.clamp(docs, 0, norms.shape[0] - 1).to(torch.int64)]
    return docs, score_block_torch(scorer, w[:, None], f, dl, avgdl), f > 0, dl


@pytest.mark.parametrize("want_dl", [False, True], ids=["", "want_dl"])
@pytest.mark.parametrize("bn", [8, -1], ids=["inline_norms", "norms_gather"])
@pytest.mark.parametrize("scorer", sorted(K3_SCORERS))
def test_decode_score_plain_equals_old_composition(scorer, bn, want_dl):
    """``decode_score_rows`` on CPU tensors (its plain version) equals the
    decode, norm unpack, clamp, scorer and ``f > 0`` it replaced, bit for
    bit, with avgdl as a float and as a 0-dim tensor."""
    bd, bf = 8, 4
    a = k3_args(k3_inputs(61, bd, bf, bn), bn)
    sc = to_port(K3_SCORERS[scorer])
    want = _old_composition(a, 37.5, bd=bd, bf=bf, bn=bn, scorer=sc)
    for avgdl in (37.5, torch.tensor(np.float32(37.5))):
        got = dc.decode_score_rows(*a, avgdl, bd=bd, bf=bf, bn=bn, scorer=sc, want_dl=want_dl)
        assert len(got) == (4 if want_dl else 3)
        assert got[2].dtype == torch.bool
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w)
    assert want[2].any() and not want[2].all()


def test_wrappers_refuse_other_devices():
    """A wrapper runs its plain version only for CPU tensors."""
    t = torch.zeros((4, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        dg.dma_row_slices([t], torch.zeros((1, 1), dtype=torch.int32, device="meta"), 2)


def test_decode_score_refuses_other_devices():
    """The scored form, like the others, runs its plain version only for
    CPU tensors."""
    a = k3_args(k3_inputs(62, 8, 4, 8), 8, to=lambda t: t.to("meta"))
    with pytest.raises(ValueError, match="no kernel"):
        dc.decode_score_rows(*a, 30.0, bd=8, bf=4, bn=8, scorer=to_port(BM25()))


def test_checked_sets_know_tensors_by_identity():
    """A wrapper's remembered pool set: found again by the same tensors
    and static key only, forgotten when a tensor dies (even if another
    takes its place), the entry unused for longest making room."""
    from iresearch_tpu_torch.device import CheckedSets

    sets = CheckedSets(size=2)
    a, b = torch.zeros(3), torch.zeros(3)
    assert sets.get((a, b), (8,)) is None
    assert sets.put((a, b), (8,), "ab") == "ab"
    assert sets.get((a, b), (8,)) == "ab"
    assert sets.get((a, b), (4,)) is None and sets.get((b, a), (8,)) is None
    assert sets.get((a, b.clone()), (8,)) is None
    sets.put((a,), (), "a")
    assert sets.get((a, b), (8,)) == "ab"  # now the newest
    sets.put((b,), (), "b")  # pushes out (a,)
    assert sets.get((a,), ()) is None and sets.get((a, b), (8,)) == "ab"
    key = next(k for k in sets._sets if k[1] == (8,))
    del b
    c = torch.zeros(3)
    sets._sets[(key[0][:1] + (id(c),), (8,))] = sets._sets.pop(key)  # c takes b's slot
    assert sets.get((a, c), (8,)) is None


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("scorer", [BM25(), TFIDF(), BoostScore()], ids=["bm25", "tfidf", "boost"])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_rowmax_kernel_matches_plain_on_card(cuda_device, scorer, mode):
    """K1 vs its plain version on the card: BM25 bit for bit, TFIDF
    (rsqrtf) and boost to rtol 1e-6."""
    conj, mm = MODES[mode]
    pools, starts, ws, norms, avgdl = _k1_inputs(31, (8, 4, 16))
    args = ([_t(p).to(cuda_device) for p in pools], _t(starts).to(cuda_device),
            _t(ws).to(cuda_device), _t(norms.astype(np.uint16)).to(cuda_device), avgdl)
    kw = dict(scorer=to_port(scorer), span_bits=(8, 4, 16), conj=conj, mm=mm)
    got = [t.cpu().numpy() for t in ds.dense_scan_rowmax(*args, **kw)]
    want = [t.cpu().numpy() for t in ds.dense_scan_rowmax_ref(*args, **kw)]
    if isinstance(scorer, BM25):
        np.testing.assert_array_equal(got[0], want[0])
    _check_rowmax(got, want[0], want[1], rtol=1e-6)


@pytest.mark.cuda
def test_row_slices_and_decode_kernels_match_plain_on_card(cuda_device):
    """K2 and K3 vs their plain versions on the card, bit for bit."""
    rng = np.random.default_rng(41)
    widths, rows, R = (64, 8, 32, 1), 300, 16
    pools = [_t(rng.integers(0, 2**32, size=(rows, w), dtype=np.uint64).astype(np.uint32)).to(cuda_device)
             for w in widths]
    starts = _t(rng.integers(0, rows - R + 1, size=(7, 4)).astype(np.int32)).to(cuda_device)
    got = dg.dma_row_slices(pools, starts, R)
    for g, w in zip(got, dg.dma_row_slices_ref(pools, starts, R)):
        assert torch.equal(g, w)
    n = 7 * R
    r = torch.arange(n, dtype=torch.int32, device=cuda_device)
    a = (got[0].reshape(n, -1), got[1].reshape(n, -1), got[3].reshape(n), r, r.flip(0))
    kd, kf = dc.decode_rows(*a, bd=16, bf=2)
    pd, pf = dc.decode_rows_ref(*a, bd=16, bf=2)
    assert torch.equal(kd, pd) and torch.equal(kf, pf)


# K1 on the card against its plain version. Each case: (span bits, Q,
# ndrows, conj, mm, spans). Q = 37 is no multiple of the kernel's query
# chunk (16) or of its queries in flight (4); ndrows = 203 and 61 are no
# multiple of its row tile (8). "dense"/"sparse" set the share of non-zero
# lanes; "zero_span" makes every third span all zero; "ties" gives every
# hit lane of a span one frequency and every lane of a row one doc length,
# so hit lanes tie; "negative" sets the top bit of some 32-bit lanes
# (f < 0, the plain version's f32 sum decides the hit).
K1_CASES = {
    **{f"s1_b{b}": ((b,), 37, 203, False, 1, "dense") for b in BITS},
    "mix_or": ((4, 2), 37, 203, False, 1, "dense"),
    "mix_and": ((4, 2), 37, 203, True, 1, "dense"),
    "s2_sparse": ((4, 2), 19, 203, False, 1, "sparse"),
    "s2_and_sparse": ((8, 1), 19, 61, True, 1, "sparse"),
    "s4_mm2": ((8, 4, 16, 2), 37, 203, False, 2, "dense"),
    "s4_mm3": ((8, 4, 16, 2), 37, 61, False, 3, "dense"),
    "s4_and_mm2": ((8, 4, 16, 2), 5, 61, True, 2, "dense"),
    "s4_ties": ((4, 4, 8, 2), 21, 61, False, 1, "ties"),
    "s17_or": (tuple(BITS[i % 6] for i in range(17)), 9, 61, False, 1, "zero_span"),
    "s17_and": (tuple(BITS[i % 6] for i in range(17)), 9, 61, True, 1, "full"),
    "s17_mm3": (tuple(BITS[i % 6] for i in range(17)), 9, 61, False, 3, "sparse"),
    "s64_or": (tuple(BITS[i % 6] for i in range(64)), 6, 61, False, 1, "sparse"),
    "s64_mm3": (tuple(BITS[i % 6] for i in range(64)), 6, 61, False, 3, "zero_span"),
    "b32_negative": ((32, 8), 21, 61, False, 1, "negative"),
}
K1_SCORERS = {
    "bm25": BM25(), "bm25_k09_b04": BM25(k=0.9, b=0.4), "bm15": BM25(b=0.0),
    "tfidf": TFIDF(), "tfidf_nonorm": TFIDF(with_norms=False), "boost": BoostScore(),
}
# sqrt of a negative frequency is NaN in both versions; no row max is defined
K1_PARAMS = [
    (case, sc) for case in sorted(K1_CASES) for sc in sorted(K1_SCORERS)
    if not (case == "b32_negative" and sc.startswith("tfidf"))
]


def _k1_card_inputs(case, seed):
    span_bits, q, ndrows, _conj, _mm, kind = K1_CASES[case]
    rng = np.random.default_rng(seed)
    nrows = ndrows + 40
    share = {"dense": 0.6, "sparse": 0.03, "zero_span": 0.5, "full": 0.97,
             "ties": 0.5, "negative": 0.5}[kind]
    pools = []
    for s, b in enumerate(span_bits):
        f = rng.integers(1, 1 << min(b, 6), size=(nrows, BLOCK), dtype=np.uint64)
        f[rng.random(f.shape) >= share] = 0
        f[rng.integers(0, nrows, size=nrows // 5)] = 0  # all-zero rows
        if kind == "zero_span" and s % 3 == 2:
            f[:] = 0
        if kind == "ties":
            f = np.where(f > 0, min(3, (1 << b) - 1), 0)
        if kind == "negative" and b == 32:
            neg = rng.random(f.shape) < 0.1
            f[neg] = rng.integers(2**31, 2**32, size=int(neg.sum()), dtype=np.uint64)
        pools.append(pack_blocks(f.astype(np.uint32), b))
    starts = rng.integers(0, nrows - ndrows + 1, size=(q, len(span_bits))).astype(np.int32)
    ws = rng.uniform(0.5, 3.0, size=(q, len(span_bits))).astype(np.float32)
    if kind == "ties":
        norms = np.repeat(rng.integers(1, 300, size=(ndrows, 1)), BLOCK, axis=1)
    else:
        norms = rng.integers(1, 300, size=(ndrows, BLOCK))
    return pools, starts, ws, norms


@pytest.mark.cuda
@pytest.mark.parametrize("case,scorer", K1_PARAMS)
@pytest.mark.parametrize("norms_dtype", [np.uint16, np.float32], ids=["u16", "f32"])
def test_rowmax_kernel_cases_match_plain_on_card(cuda_device, case, scorer, norms_dtype):
    """K1 vs its plain version on every hit rule, span count, width class
    and score kind: BM25 (every setting) and boost bit for bit, max and
    argmax, -inf rows included; TFIDF (rsqrtf) to rtol 1e-6."""
    span_bits, _q, _n, conj, mm, _kind = K1_CASES[case]
    pools, starts, ws, norms = _k1_card_inputs(case, 51)
    dev = cuda_device
    args = ([_t(p).to(dev) for p in pools], _t(starts).to(dev), _t(ws).to(dev),
            _t(norms.astype(norms_dtype)).to(dev), 41.7)
    kw = dict(scorer=to_port(K1_SCORERS[scorer]), span_bits=span_bits, conj=conj, mm=mm)
    got = [t.cpu().numpy() for t in ds.dense_scan_rowmax(*args, **kw)]
    want = [t.cpu().numpy() for t in ds.dense_scan_rowmax_ref(*args, **kw)]
    if scorer.startswith("tfidf"):
        _check_rowmax(got, want[0], want[1], rtol=1e-6)
    else:
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    if case.startswith("mix") or case == "s4_mm2":
        assert np.isfinite(want[0]).any() and not np.isfinite(want[0]).all()


WIDTHS = tuple(BITS)  # 1, 2, 4, 8, 16, 32
K3_RS = (1, 7, 8, 9, 3001)  # around the kernel's 8 rows per block, ragged


def _dev(dev):
    return lambda t: t.to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("bf", WIDTHS)
@pytest.mark.parametrize("bd", WIDTHS)
def test_decode_kernel_cases_match_plain_on_card(cuda_device, bd, bf):
    """K3 (a warp per row) vs its plain version for every width pair and
    row count, repeated and sentinel rows among them, bit for bit."""
    for R in K3_RS:
        a = k3_args(k3_inputs(100 + R, bd, bf, 8, R=R), 8, to=_dev(cuda_device))[:5]
        got = dc.decode_rows(*a, bd=bd, bf=bf)
        want = dc.decode_rows_ref(*a, bd=bd, bf=bf)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), R


@pytest.mark.cuda
def test_decode_kernel_wraps_and_guards_on_card(cuda_device):
    """The prefix sum wraps in int32 as the plain version's does; a row id
    outside its pool decodes as zeros instead of reading foreign memory."""
    rng = np.random.default_rng(5)
    deltas = rng.integers(2**30, 2**32, size=(6, BLOCK), dtype=np.uint64).astype(np.uint32)
    freqs = rng.integers(0, 2**32, size=(6, BLOCK), dtype=np.uint64).astype(np.uint32)
    base = np.asarray([2**31 - 1, -2**31, 0, 7, -5, 2**31 - 2], np.int32)
    to = _dev(cuda_device)
    dw, fw, bs = to(_t(pack_blocks(deltas, 32))), to(_t(pack_blocks(freqs, 32))), to(_t(base))
    rows = to(torch.arange(6, dtype=torch.int32))
    got = dc.decode_rows(dw, fw, bs, rows, rows.flip(0), bd=32, bf=32)
    want = dc.decode_rows_ref(dw, fw, bs, rows, rows.flip(0), bd=32, bf=32)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert (want[0][:, 1:] < want[0][:, :-1]).any()  # it did wrap
    out = to(torch.tensor([-1, 6, 2**31 - 1, 3], dtype=torch.int32))
    ok = to(torch.tensor([3, 3, 3, 3], dtype=torch.int32))
    d, f = dc.decode_rows(dw, fw, bs, out, ok, bd=32, bf=32)
    assert not d[:3].any() and torch.equal(d[3], want[0][3]) and torch.equal(f[0], want[1][2])
    d, f = dc.decode_rows(dw, fw, bs, ok, out, bd=32, bf=32)
    assert not f[:3].any() and torch.equal(d[0], want[0][3])
    w = to(torch.ones(4))
    d, sc, m, dl = dc.decode_score_rows(dw, fw, bs, out, out, dw, out, None, w, 30.0,
                                        bd=32, bf=32, bn=32, scorer=to_port(BM25()), want_dl=True)
    assert not d[:3].any() and not sc[:3].any() and not m[:3].any() and (dl[:3] == 1).all()


@pytest.mark.cuda
@pytest.mark.parametrize("scorer", sorted(K3_SCORERS))
@pytest.mark.parametrize("bn", WIDTHS + (-1,))
def test_decode_score_kernel_cases_match_plain_on_card(cuda_device, bn, scorer):
    """K3's scored form vs its plain version for every norm width (and the
    norms gather), score kind and row count, with and without dl, avgdl as
    a float and as a device tensor: docs, match flags, dl and the scores of
    BM25 and boost bit for bit, TFIDF to rtol 1e-6."""
    sc = to_port(K3_SCORERS[scorer])
    for i, R in enumerate(K3_RS):
        bd, bf = WIDTHS[(i + max(bn, 0)) % 6], WIDTHS[(2 * i + 1) % 6]
        a = k3_args(k3_inputs(200 + R, bd, bf, bn, R=R), bn, to=_dev(cuda_device))
        avgdl = 37.5 if i % 2 else torch.tensor(np.float32(37.5), device=cuda_device)
        kw = dict(bd=bd, bf=bf, bn=bn, scorer=sc, want_dl=bool(i % 2) or R == 3001)
        got = dc.decode_score_rows(*a, avgdl, **kw)
        want = dc.decode_score_rows_ref(*a, avgdl, **kw)
        torch.cuda.synchronize()
        assert len(got) == len(want)
        for j, (g, w) in enumerate(zip(got, want)):
            assert g.dtype == w.dtype and g.shape == w.shape
            if j == 1 and scorer.startswith("tfidf"):
                torch.testing.assert_close(g, w, rtol=1e-6, atol=0.0)
            else:
                assert torch.equal(g, w), (R, j)


@pytest.mark.cuda
@pytest.mark.parametrize("R", [1, 64])
@pytest.mark.parametrize("Q", [1, 5, 75])
def test_row_slices_kernel_cases_match_plain_on_card(cuda_device, Q, R):
    """K2 (flat grid of 4 KB pieces) vs its plain version for 1-4 pools of
    1, 4 and 128 words a row in every order (so one-word pools start
    windows off a 16-byte line), windows ending in the pool's last row,
    and a window past the end written as zeros."""
    rng = np.random.default_rng(Q * 100 + R)
    rows = 300
    widths = {w: _t(rng.integers(0, 2**32, size=(rows, w), dtype=np.uint64).astype(np.uint32)).to(cuda_device)
              for w in (1, 4, 128)}
    for combo in [(1,), (4,), (128,), (1, 128), (128, 1, 4), (1, 4, 128, 1), (4, 1, 1, 128)]:
        pools = [widths[w] for w in combo]
        st = rng.integers(0, rows - R + 1, size=(Q, len(combo))).astype(np.int32)
        st[-1] = rows - R  # ends in the last row
        starts = _t(st).to(cuda_device)
        got = dg.dma_row_slices(pools, starts, R)
        torch.cuda.synchronize()
        for g, w in zip(got, dg.dma_row_slices_ref(pools, starts, R)):
            assert g.shape == w.shape and g.is_contiguous() and torch.equal(g, w), combo
        assert all(g.data_ptr() % 16 == 0 for g in got)
        st[0] = rows - R + 1  # one row past the end: zeros there
        got = dg.dma_row_slices(pools, _t(st).to(cuda_device), R)
        for g, p in zip(got, pools):
            assert not g[0, R - 1].any() and torch.equal(g[0, : R - 1], p[rows - R + 1 :])
            assert Q == 1 or torch.equal(g[-1], p[rows - R :])


@pytest.mark.cuda
def test_wrappers_check_their_pools_once_on_card(cuda_device):
    """A first call with a wrong dtype, width or device raises; a pool set
    that passed is not checked again, and still decodes the same."""
    a = k3_args(k3_inputs(63, 8, 4, 8), 8, to=_dev(cuda_device))
    sc = to_port(BM25())
    with pytest.raises(TypeError, match="dtype"):
        dc.decode_rows(a[0].float(), *a[1:5], bd=8, bf=4)
    with pytest.raises(ValueError, match="width"):
        dc.decode_rows(*a[:5], bd=4, bf=4)
    with pytest.raises(ValueError, match="expected"):
        dc.decode_score_rows(a[0], a[1].cpu(), *a[2:], 30.0, bd=8, bf=4, bn=8, scorer=sc)
    with pytest.raises(TypeError, match="dtype"):
        dg.dma_row_slices([a[0].float()], a[3][:, None], 2)
    first = dc.decode_score_rows(*a, 30.0, bd=8, bf=4, bn=8, scorer=sc)
    again = dc.decode_score_rows(*a, 30.0, bd=8, bf=4, bn=8, scorer=sc)
    assert all(torch.equal(x, y) for x, y in zip(first, again))
    with pytest.raises(TypeError, match="dtype"):
        dc.decode_score_rows(*a[:8], a[8].double(), 30.0, bd=8, bf=4, bn=8, scorer=sc)


# --- the index-wide path on the card: phrases, the segment merge, inversion ---


@pytest.fixture(scope="module")
def card_segments():
    """Three bench-law segments of unequal sizes (seeds 42, 43, 44), built
    by the port. Module-scoped fixtures are set up before ``cuda_device``,
    so this one skips without a card too, before it builds anything."""
    from iresearch_tpu_torch import bench_mix
    from iresearch_tpu_torch.index.segment import SegmentReader

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return [SegmentReader(f"card{si}", bench_mix.build_segment_data(n, bench_mix.SEED + si))
            for si, n in enumerate((20_000, 5_000, 100))]


def _card_phrases(sr):
    from iresearch_tpu_torch import bench_mix
    from iresearch_tpu_torch.search import filters as PF

    term_at = bench_mix._ranked(sr)[0]
    two = PF.ByPhrase("body", [term_at(3), term_at(4)])
    return {
        "two": two,
        "gap": PF.ByPhrase("body", [term_at(2), term_at(3), (1, term_at(5))]),
        "and": PF.And(two, PF.ByTerm("body", term_at(9))),
        "or": PF.Or(two, PF.ByTerm("body", term_at(2000))),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("scorer", [BM25(), TFIDF()], ids=["bm25", "tfidf"])
@pytest.mark.parametrize("name", ["two", "gap", "and", "or"])
def test_phrase_on_card_matches_plain_and_host(cuda_device, card_segments, name, scorer):
    """The single query's default runs the phrase on the card: K3's plain
    form launches once per part, and the top-k equals the plain-torch run,
    the host-evaluated leaf and the numpy oracle."""
    from iresearch_tpu_torch.exec.executor import DeviceQuery
    from iresearch_tpu_torch.kernels import build as kb
    from iresearch_tpu_torch.search.host_eval import HostQuery

    sr = card_segments[0]
    flt, sc = _card_phrases(sr)[name], to_port(scorer)
    dq = DeviceQuery(flt, [sr], sc)  # the card, device_phrase=True
    plan = dq.plan(0)
    assert plan.device_aux
    kb.reset_launch_counts()
    vals, docs = dq.execute_segment(0, 10)
    assert kb.launch_counts()["decode_rows"] == sum(len(s.parts) for _a, s in plan.device_aux)
    pv, pd = dq.execute_segment(0, 10, plain=True)
    np.testing.assert_array_equal(docs, pd)
    np.testing.assert_allclose(vals, pv, rtol=1e-5, atol=0.0)
    hv, hd = DeviceQuery(flt, [sr], sc, device_phrase=False).execute_segment(0, 10)
    np.testing.assert_allclose(vals, hv, rtol=1e-5, atol=1e-6)
    r = HostQuery(flt, [sr], sc).execute(0)
    fin = np.isfinite(vals)
    assert fin.any() and r.match[docs[fin]].all()
    np.testing.assert_allclose(vals[fin], r.score[docs[fin]], rtol=1e-5, atol=1e-6)
    assert int(fin.sum()) == min(10, int(r.match.sum()))


@pytest.mark.cuda
@pytest.mark.parametrize("scorer", [BM25(), TFIDF()], ids=["bm25", "tfidf"])
def test_merged_batch_on_card_matches_plain_and_host_merge(cuda_device, card_segments, scorer):
    """``prepare_all(k).run()`` on the card: no synchronise inside the
    pass, equal to its plain-torch run and to the host merge, a 100-doc
    segment padded to k among the three."""
    from iresearch_tpu_torch import bench_mix
    from iresearch_tpu_torch.exec.batch import QueryBatch

    filters = [f for _c, f in bench_mix.task_mix(card_segments[0])[::8]]
    qb = QueryBatch(filters, card_segments, to_port(scorer), wand=True)
    mb = qb.prepare_all(10)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        vals, docs = mb.run()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert vals.device == cuda_device and vals.shape == docs.shape == (len(filters), 10)
    pv, pd = mb.run(plain=True)
    assert torch.equal(docs, pd)
    torch.testing.assert_close(vals, pv, rtol=1e-5, atol=0.0)
    vals, docs = vals.cpu().numpy(), docs.cpu().numpy()
    for qi, ref in enumerate(qb.search(10)):
        fin = np.isfinite(vals[qi])
        assert docs[qi][fin].tolist() == [d for d, _v in ref], qi
        np.testing.assert_allclose(vals[qi][fin], [v for _d, v in ref], rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["stream", "empty", "one_token"])
def test_invert_device_on_card_matches_numpy(cuda_device, case):
    import dataclasses

    from iresearch_tpu_torch import bench_mix
    from iresearch_tpu_torch.index.invert import invert_device, invert_numpy

    if case == "stream":
        args = bench_mix.token_stream(10_000, 43) + (bench_mix.VOCAB, 10_000)
    elif case == "empty":
        args = (np.zeros(0), np.zeros(0), np.zeros(0, np.uint32), 5, 10)
    else:
        args = (np.array([3]), np.array([7]), np.array([0], np.uint32), 5, 10)
    got, want = invert_device(*args), invert_numpy(*args)  # device=None: the card
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        assert a.dtype == b.dtype and a.shape == b.shape, f.name
        np.testing.assert_array_equal(a, b, err_msg=f.name)


@pytest.mark.cuda
def test_single_query_dslice_on_card(cuda_device, card_segments):
    """A dslice group of one query (a lone sparse term through
    ``DeviceQuery``, or alone in its batch group): the weight expanded over
    the window's rows must reach K3's scored form contiguous."""
    from iresearch_tpu_torch import bench_mix
    from iresearch_tpu_torch.exec.executor import DeviceQuery

    sr = card_segments[0]
    flt = [f for c, f in bench_mix.task_mix(sr) if c == "LowTerm"][0]
    dq = DeviceQuery(flt, [sr], to_port(BM25()))
    assert dq.single_call(0, 10).tier == "dslice"
    vals, docs = dq.execute_segment(0, 10)
    pv, pd = dq.execute_segment(0, 10, plain=True)
    np.testing.assert_array_equal(docs, pd)
    np.testing.assert_array_equal(vals, pv)
    assert np.isfinite(vals[0])


# --- the fused pass on the card: one CUDA graph per prepared batch ---


def _card_batch(card_segments, filters=None, segs=None):
    from iresearch_tpu_torch import bench_mix
    from iresearch_tpu_torch.exec.batch import QueryBatch

    if filters is None:
        filters = [f for _c, f in bench_mix.task_mix(card_segments[0])[::8]]
    return QueryBatch(filters, segs or card_segments, to_port(BM25()), wand=True)


def _agree(got, want):
    """Two runs' (vals, docs): docs equal, scores to rtol 1e-5 (a fold's
    float scatter-adds sum in no fixed order on the card, so two runs may
    differ in the last ulp, ``exec/executor.py``)."""
    assert torch.equal(got[1], want[1])
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=0.0)


def _swapped_in_group(prep, filters):
    """``filters`` with two queries of one group of ``prep`` swapped: a
    batch of the same structure whose packed rows differ."""
    a, b = next(qis[:2] for _t, qis, *_r in prep.calls
                if len(qis) >= 2 and filters[qis[0]] != filters[qis[1]])
    out = list(filters)
    out[a], out[b] = out[b], out[a]
    return out


@pytest.mark.cuda
def test_fused_graph_equals_eager_on_card(cuda_device, card_segments):
    """``prepare_all(10).run()`` replays one graph of every segment's
    groups and the merge: the eager pass's and the plain run's result; a
    replay counts the kernels' launches that the capture recorded."""
    from iresearch_tpu_torch.exec import batch as B
    from iresearch_tpu_torch.kernels import build as kb

    B.clear_fused_cache()
    mb = _card_batch(card_segments).prepare_all(10)
    vals, docs = mb.run()
    entry = B._FUSED_CACHE[mb.fused_key()]
    assert entry.graph is not None and entry.nodes > 0
    assert entry.launches.get("dense_scan_rowmax") and entry.launches.get("decode_score_rows")
    _agree((vals, docs), mb.run(fused=False))
    _agree((vals, docs), mb.run(plain=True))
    kb.reset_launch_counts()
    mb.run()
    torch.cuda.synchronize()
    assert {n: c for n, c in kb.launch_counts().items() if c} == entry.launches
    prep = mb.preps[0]
    for (g, qg), (e, qe) in zip(prep.run_grouped(), prep.run_grouped(fused=False)):
        assert qg == qe
        _agree(g, e)
    B.clear_fused_cache()


@pytest.mark.cuda
def test_fused_hit_does_not_capture_again_on_card(cuda_device, card_segments, monkeypatch):
    """Fresh batches of one structure: the first captures, the others copy
    their buffers into its entry and replay."""
    from iresearch_tpu_torch.exec import batch as B

    B.clear_fused_cache()
    captures = []
    real = B._FusedPass.capture
    monkeypatch.setattr(B._FusedPass, "capture",
                        lambda self, body: captures.append(self) or real(self, body))
    first = _card_batch(card_segments).prepare_all(10).run()
    for _ in range(3):
        _agree(_card_batch(card_segments).prepare_all(10).run(), first)
    assert len(captures) == 1 and len(B._FUSED_CACHE) == 1
    assert next(iter(B._FUSED_CACHE.values())) is captures[0]
    B.clear_fused_cache()


@pytest.mark.cuda
def test_fused_result_survives_later_replays_on_card(cuda_device, card_segments):
    """What a fused call returned is not overwritten when the same graph
    replays for a batch whose results differ."""
    from iresearch_tpu_torch import bench_mix
    from iresearch_tpu_torch.exec import batch as B

    B.clear_fused_cache()
    seg = card_segments[:1]
    filters = [f for _c, f in bench_mix.task_mix(seg[0])[::8]]
    prep = _card_batch(card_segments, filters, seg).prepare(0, 10)
    got = prep.run_grouped()
    kept = [(v.clone(), d.clone()) for (v, d), _q in got]
    fresh = _card_batch(card_segments, _swapped_in_group(prep, filters), seg).prepare(0, 10)
    assert fresh._key == prep._key
    other = fresh.run_grouped()
    assert len(B._FUSED_CACHE) == 1
    assert any(not torch.equal(d, k[1]) for ((_v, d), _q), k in zip(other, kept))
    for ((v, d), _q), (kv, kd) in zip(got, kept):
        assert torch.equal(v, kv) and torch.equal(d, kd)
    for (g, _q), (e, _q2) in zip(other, fresh.run_grouped(fused=False)):
        _agree(g, e)
    B.clear_fused_cache()


@pytest.mark.cuda
def test_fused_capture_under_sync_debug_error_on_card(cuda_device, card_segments):
    """Capture and replay with PyTorch's sync debug mode set to raise: the
    index pass, and a batch with a query per tier that decodes postings
    rows (fold, aux, wand, direct, sort, join, gridmix), each agreeing with
    its eager run."""
    from iresearch_tpu_torch import bench_mix
    from iresearch_tpu_torch.exec import batch as B

    B.clear_fused_cache()
    mb = _card_batch(card_segments).prepare_all(10)
    tasks = bench_mix.tier_tasks(card_segments[0])
    qb = _card_batch(card_segments, [f for _t, f, _k in tasks], card_segments[:1])
    for q, (_t, _f, knobs) in zip(qb.queries, tasks):
        if knobs:
            with bench_mix.planner_knobs(**knobs):
                q.plan(0)
    tiers = qb.prepare(0, 10)
    assert [c[0] for c in tiers.calls] == [t for t, _f, _k in tasks]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        runs = [(mb.run(), tiers.run_grouped()) for _ in range(2)]  # a miss, then a hit
    finally:
        torch.cuda.set_sync_debug_mode("default")
    eager = mb.run(fused=False)
    for merged, grouped in runs:
        _agree(merged, eager)
        for (g, _q), (e, _q2) in zip(grouped, tiers.run_grouped(fused=False)):
            _agree(g, e)
    assert len(B._FUSED_CACHE) == 2
    B.clear_fused_cache()


# --- the single query and the sharded group on the card: one graph each ---


SINGLE_TIERS = ["skyline", "scan", "dslice", "fold", "aux", "wand", "direct", "sort", "join",
                "gridmix", "phrase"]


def _card_single(sr, flt, wand=False, knobs=None, device_phrase=True):
    """A ``DeviceQuery`` on the card, its plan compiled under ``knobs``."""
    from iresearch_tpu_torch import bench_mix
    from iresearch_tpu_torch.exec.executor import DeviceQuery

    dq = DeviceQuery(flt, [sr], to_port(BM25()), wand=wand, device_phrase=device_phrase)
    with bench_mix.planner_knobs(**(knobs or {})):
        dq.plan(0)
    return dq


def _single_of(card_segments, monkeypatch, tier):
    """The card's ``DeviceQuery`` of ``bench_mix.single_tier_tasks``'s
    query for ``tier`` (the skyline tier at 20,000 docs with the scan
    ratio lowered to 8)."""
    from iresearch_tpu_torch import bench_mix
    from iresearch_tpu_torch.exec import skyline

    if tier == "skyline":
        monkeypatch.setattr(skyline, "SKYLINE_SCAN_RATIO", 8)
    sr = card_segments[0]
    flt, wand, knobs, dp = bench_mix.single_tier_tasks(sr)[tier]
    dq = _card_single(sr, flt, wand, knobs, dp)
    assert dq.single_call(0, 10).tier == ("aux" if tier == "phrase" else tier)
    return dq


@pytest.mark.cuda
@pytest.mark.parametrize("tier", SINGLE_TIERS)
def test_single_query_graph_equals_eager_on_card(cuda_device, card_segments, monkeypatch, tier):
    """``execute_segment_async`` captures the call into one graph under the
    sync debug mode set to raise and replays it: the eager and the plain
    run's result, and a second replay (a hit) the same; a replay counts
    the launches its capture recorded."""
    from iresearch_tpu_torch.exec import batch as B
    from iresearch_tpu_torch.kernels import build as kb

    B.clear_fused_cache()
    dq = _single_of(card_segments, monkeypatch, tier)
    dq.single_call(0, 10).fused_entry()  # a phrase's rows are made here, outside the check
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = dq.execute_segment_async(0, 10)
        kb.reset_launch_counts()
        again = dq.execute_segment_async(0, 10)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    entry = B._FUSED_KINDS["single"][dq.single_call(0, 10).fused_entry()[0]]
    assert entry.graph is not None and entry.nodes > 0 and entry.hits == 1
    assert {n: c for n, c in kb.launch_counts().items() if c} == entry.launches
    assert not B._FUSED_CACHE
    for other in (again, dq.execute_segment_async(0, 10, fused=False),
                  dq.execute_segment_async(0, 10, plain=True)):
        _agree(got, other)
    B.clear_fused_cache()


@pytest.mark.cuda
@pytest.mark.parametrize("tier", ["dslice", "wand", "phrase"])
def test_fresh_single_query_does_not_capture_again_on_card(cuda_device, card_segments,
                                                           monkeypatch, tier):
    """A fresh ``DeviceQuery`` of another filter with the same signature (a
    Low term, a High disjunction under WAND, a phrase) copies its inputs
    into the first one's entry and replays it: no capture, its own eager
    result; the first result is unchanged."""
    from iresearch_tpu_torch import bench_mix
    from iresearch_tpu_torch.exec import batch as B
    from iresearch_tpu_torch.search import filters as PF

    B.clear_fused_cache()
    sr = card_segments[0]
    term_at, high, _med, low = bench_mix._ranked(sr)
    T = lambda t: PF.ByTerm("body", t)  # noqa: E731
    first, others, kw = {
        "dslice": (T(low[0]), [T(t) for t in low[1:]], {}),
        "wand": (PF.Or(T(high[0]), T(high[1])),
                 [PF.Or(T(high[i]), T(high[i + 1])) for i in range(2, 40)], dict(wand=True)),
        "phrase": (PF.ByPhrase("body", [term_at(30), term_at(31)]),
                   [PF.ByPhrase("body", [term_at(i), term_at(i + 1)]) for i in range(10, 40)], {}),
    }[tier]
    dq = _card_single(sr, first, **kw)
    got = dq.execute_segment_async(0, 10)
    kept = [t.clone() for t in got]
    key = dq.single_call(0, 10).fused_entry()[0]
    captures = []
    real = B._FusedPass.capture
    monkeypatch.setattr(B._FusedPass, "capture",
                        lambda self, body: captures.append(self) or real(self, body))
    fresh = next(q for q in (_card_single(sr, f, **kw) for f in others)
                 if q.single_call(0, 10).fused_entry()[0] == key
                 and not torch.equal(q.execute_segment_async(0, 10, fused=False)[1], got[1]))
    mine = fresh.execute_segment_async(0, 10)
    assert not captures and B._FUSED_KINDS["single"][key].hits == 1
    _agree(mine, fresh.execute_segment_async(0, 10, fused=False))
    assert torch.equal(got[0], kept[0]) and torch.equal(got[1], kept[1])
    B.clear_fused_cache()


def _card_sharded(card_segments, filters=None):
    """A searcher over every visible card (one shard each) and the mix."""
    from iresearch_tpu_torch import bench_mix
    from iresearch_tpu_torch.parallel import ShardedSearcher

    if filters is None:
        filters = [f for _c, f in bench_mix.task_mix(card_segments[0])[::8]]
    ss = ShardedSearcher(card_segments)
    return ss, filters


@pytest.mark.cuda
@pytest.mark.parametrize("queries", ["mix", "phrases"])
def test_sharded_group_graph_equals_eager_on_card(cuda_device, card_segments, monkeypatch,
                                                  queries):
    """``prepare_many(queries, wand=True).run(10)`` (the mix, or phrases in
    the keys form) replays one graph per signature group, captured under
    the sync debug mode set to raise: the eager and the plain run's
    result; a fresh ``prepare_many`` of the queries replays every group's
    graph with no capture, and the first result survives its replays."""
    from iresearch_tpu_torch import bench_mix
    from iresearch_tpu_torch.exec import batch as B
    from iresearch_tpu_torch.search import filters as PF

    B.clear_fused_cache()
    term_at = bench_mix._ranked(card_segments[0])[0]
    phrases = [PF.ByPhrase("body", [term_at(i), term_at(i + 1)]) for i in (20, 30)] + [
        PF.ByPhrase("body", [term_at(20), term_at(21), (1, term_at(22))])]
    ss, filters = _card_sharded(card_segments, phrases if queries == "phrases" else None)
    prep = ss.prepare_many(filters, to_port(BM25()), wand=True, k_max=10)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = prep.run(10)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    entries = list(B._FUSED_KINDS["sharded"].values())
    assert len(entries) == len(prep.groups)
    assert all(p.graph is not None for e in entries for p in e.passes)
    assert all(kw.get("phrase_keys") for *_r, kw in prep.calls) == (queries == "phrases")
    kept = [(v.clone(), d.clone()) for v, d in got]
    for g, e in zip(got, prep.run(10, fused=False)):
        _agree(g, e)
    for g, e in zip(got, prep.run(10, plain=True)):
        _agree(g, e)
    captures = []
    real = B._FusedPass.capture
    monkeypatch.setattr(B._FusedPass, "capture",
                        lambda self, body: captures.append(self) or real(self, body))
    fresh = ss.prepare_many(filters[::-1], to_port(BM25()), wand=True, k_max=10)
    other = fresh.run(10)
    assert not captures and all(e.hits == 1 for e in entries)
    for g, e in zip(other, fresh.run(10, fused=False)):
        _agree(g, e)
    for (v, d), (kv, kd) in zip(got, kept):
        assert torch.equal(v, kv) and torch.equal(d, kd)
    B.clear_fused_cache()


# --- several devices: each kernel on its tensors' card, the mesh -------------


@pytest.fixture
def second_card(cuda_device):
    """cuda:1 with cuda:0 current; skips on a host of one card."""
    if torch.cuda.device_count() < 2:
        pytest.skip(f"needs two cards ({torch.cuda.device_count()} visible)")
    torch.cuda.set_device(0)
    return torch.device("cuda", 1)


@pytest.mark.cuda
def test_kernels_launch_on_their_tensors_card(second_card):
    """K1, K2, K3's two forms and K4 on cuda:1 tensors while cuda:0 is
    current, each against its plain version (bit for bit): each wrapper makes
    its tensors' card current around the launch, and cuda:0 is current
    again after it."""
    dev, to = second_card, _dev(second_card)
    pools, starts, ws, norms, avgdl = _k1_inputs(31, (8, 4, 16))
    args = ([to(_t(p)) for p in pools], to(_t(starts)), to(_t(ws)),
            to(_t(norms.astype(np.uint16))), avgdl)
    kw = dict(scorer=to_port(BM25()), span_bits=(8, 4, 16))
    got = ds.dense_scan_rowmax(*args, **kw)
    want = [t.cpu().numpy() for t in ds.dense_scan_rowmax_ref(*args, **kw)]
    assert got[0].device == dev and torch.cuda.current_device() == 0
    np.testing.assert_array_equal(got[0].cpu().numpy(), want[0])
    _check_rowmax([t.cpu().numpy() for t in got], want[0], want[1], rtol=0.0)
    rng = np.random.default_rng(41)
    pools = [to(_t(rng.integers(0, 2**32, size=(300, w), dtype=np.uint64).astype(np.uint32)))
             for w in (64, 8, 32, 1)]
    starts = to(_t(rng.integers(0, 300 - 16 + 1, size=(7, 4)).astype(np.int32)))
    rows = dg.dma_row_slices(pools, starts, 16)
    assert rows[0].device == dev and torch.cuda.current_device() == 0
    for g, w in zip(rows, dg.dma_row_slices_ref(pools, starts, 16)):
        assert torch.equal(g, w)
    r = torch.arange(7 * 16, dtype=torch.int32, device=dev)
    a = (rows[0].reshape(7 * 16, -1), rows[1].reshape(7 * 16, -1), rows[3].reshape(-1), r,
         r.flip(0))
    for g, w in zip(dc.decode_rows(*a, bd=16, bf=2), dc.decode_rows_ref(*a, bd=16, bf=2)):
        assert g.device == dev and torch.equal(g, w)
    for bn in (8, -1):
        a = k3_args(k3_inputs(7, 8, 4, bn, R=9), bn, to=to)
        avgdl = torch.tensor(np.float32(37.5), device=dev)
        kw = dict(bd=8, bf=4, bn=bn, scorer=to_port(BM25()), want_dl=True)
        for g, w in zip(dc.decode_score_rows(*a, avgdl, **kw),
                        dc.decode_score_rows_ref(*a, avgdl, **kw)):
            assert g.device == dev and torch.equal(g, w)
    from iresearch_tpu_torch.ops import topk as tk

    scores = to(torch.from_numpy(_topk_scores(rng, 5, 20_000, "random")))
    got = tk.topk_docs(scores, None, 100)
    assert got[0].device == dev and torch.cuda.current_device() == 0
    _same_topk(got, tk.topk_docs_ref(scores, None, 100))
    assert torch.cuda.current_device() == 0


@pytest.mark.cuda
def test_entry_points_on_second_card(second_card, card_segments):
    """``DeviceQuery`` (a query of each kernel's tier, fused and plain),
    ``QueryBatch(...).prepare_all`` (fused, against plain) and
    ``invert_device`` with ``device="cuda:1"`` while cuda:0 is current: their
    results lie on cuda:1 and equal the plain runs and cuda:0's."""
    import dataclasses

    from iresearch_tpu_torch import bench_mix
    from iresearch_tpu_torch.exec import batch as B
    from iresearch_tpu_torch.exec.batch import QueryBatch
    from iresearch_tpu_torch.exec.executor import DeviceQuery
    from iresearch_tpu_torch.index.invert import invert_device, invert_numpy
    from iresearch_tpu_torch.kernels import build as kb

    dev, sr = second_card, card_segments[0]
    B.clear_fused_cache()
    tasks = bench_mix.single_tier_tasks(sr)
    kb.reset_launch_counts()
    for tier in ("scan", "dslice", "phrase", "fold"):
        flt, wand, knobs, dp = tasks[tier]
        got = []
        for d in (dev, torch.device("cuda", 0)):
            dq = DeviceQuery(flt, [sr], to_port(BM25()), wand=wand, device_phrase=dp, device=d)
            with bench_mix.planner_knobs(**(knobs or {})):
                dq.plan(0)
            v, dd = dq.execute_segment_async(0, 10)
            assert v.device == d
            _agree((v, dd), dq.execute_segment_async(0, 10, plain=True))
            got.append((v.cpu(), dd.cpu()))
        _agree(*got)
    assert all(kb.launch_counts()[n] for n in kb.KERNELS), kb.launch_counts()
    filters = [f for _c, f in bench_mix.task_mix(sr)[::8]]
    mb = QueryBatch(filters, card_segments, to_port(BM25()), wand=True, device=dev).prepare_all(10)
    vals, docs = mb.run()
    assert vals.device == dev and torch.cuda.current_device() == 0
    _agree((vals, docs), mb.run(plain=True))
    ref = QueryBatch(filters, card_segments, to_port(BM25()), wand=True).prepare_all(10).run()
    _agree((vals.cpu(), docs.cpu()), (ref[0].cpu(), ref[1].cpu()))
    args = bench_mix.token_stream(10_000, 43) + (bench_mix.VOCAB, 10_000)
    got, want = invert_device(*args, device=dev), invert_numpy(*args)
    for f in dataclasses.fields(want):
        np.testing.assert_array_equal(getattr(got, f.name), getattr(want, f.name), err_msg=f.name)
    B.clear_fused_cache()


def _mesh_agrees(card_segments, devices):
    """The mix (with WAND) and two phrases in the keys form through
    ``ShardedSearcher(card_segments, devices=devices)``, fused and eager,
    against the one-shard searcher on cuda:0: the same matches and docs,
    the scores bit for bit outside the WAND groups (a last ulp there,
    PERF.md), the results on the mesh's first device; returns the mesh's
    searcher. A query of fewer than k matches fills its list with -inf
    non-matches, whose docs depend on the padding (a shard without a
    segment gives doc 0), so only the matches' docs are compared."""
    from iresearch_tpu_torch import bench_mix
    from iresearch_tpu_torch.exec import batch as B
    from iresearch_tpu_torch.parallel import ShardedSearcher
    from iresearch_tpu_torch.search import filters as PF

    B.clear_fused_cache()
    term_at = bench_mix._ranked(card_segments[0])[0]
    filters = [f for _c, f in bench_mix.task_mix(card_segments[0])[::8]] + [
        PF.ByPhrase("body", [term_at(20), term_at(21)]),
        PF.ByPhrase("body", [term_at(20), term_at(21), (1, term_at(22))])]
    one = ShardedSearcher(card_segments, device="cuda:0")
    mesh = ShardedSearcher(card_segments, devices=devices)
    assert mesh.D == len(devices) and mesh.device == torch.device(devices[0])
    want = one.prepare_many(filters, to_port(BM25()), wand=True, k_max=10)
    prep = mesh.prepare_many(filters, to_port(BM25()), wand=True, k_max=10)
    assert [g[:3] for g in prep.groups] == [g[:3] for g in want.groups]
    assert any(kw.get("phrase_keys") for *_r, kw in prep.calls)
    ref = want.run(10)
    for fused in (True, False):
        got = prep.run(10, fused=fused)
        for qis, _m, use_wand, _c in prep.groups:
            for qi in qis:
                assert got[qi][0].device == mesh.device
                g = (got[qi][0].cpu(), got[qi][1].cpu())
                w = (ref[qi][0].cpu(), ref[qi][1].cpu())
                fin = torch.isfinite(w[0])
                assert torch.equal(torch.isfinite(g[0]), fin), (fused, qi)
                assert torch.equal(g[1][fin], w[1][fin]), (fused, qi)
                if use_wand:
                    torch.testing.assert_close(g[0], w[0], rtol=1e-5, atol=0.0)
                else:
                    assert torch.equal(g[0], w[0]), (fused, qi)
    entries = [B._FUSED_KINDS["sharded"][prep.fused_key(gi, min(10, mesh.nd_pad, g[3]))]
               for gi, g in enumerate(prep.groups)]
    live = sum(1 for _g, _d, segs in mesh.shards if segs)
    assert all(len(e.passes) == live and all(p.graph is not None for p in e.passes)
               for e in entries)
    assert {p.device for e in entries for p in e.passes} == {
        d for _g, d, segs in mesh.shards if segs}
    B.clear_fused_cache()
    return mesh


@pytest.mark.cuda
def test_mesh_on_one_card_equals_one_shard(cuda_device, card_segments):
    """Four shards on cuda:0 (the three segments, one shard without one)
    against ``device=cuda:0``."""
    mesh = _mesh_agrees(card_segments, [cuda_device] * 4)
    assert [segs for _g, _d, segs in mesh.shards] == [[0], [1], [2], []]


@pytest.mark.cuda
def test_mesh_of_two_cards_equals_one_shard(second_card, card_segments):
    """Shards on cuda:0 and cuda:1, the candidates gathered onto cuda:0,
    against ``device=cuda:0``."""
    mesh = _mesh_agrees(card_segments, [torch.device("cuda", 0), second_card])
    assert [segs for _g, _d, segs in mesh.shards] == [[0, 1], [2]]


@pytest.fixture
def nccl_group(cuda_device):
    """An NCCL group of this one process on cuda:0 (its communicator made
    at once), destroyed after the test with every graph freed first."""
    import socket

    import torch.distributed as dist

    from iresearch_tpu_torch.exec import batch as B

    if not dist.is_nccl_available():
        pytest.skip("this torch has no NCCL")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", rank=0,
                            world_size=1, device_id=cuda_device)
    try:
        yield dist.group.WORLD
    finally:
        B.clear_fused_cache()
        dist.destroy_process_group()


@pytest.mark.cuda
def test_nccl_group_of_one_captures_the_join(nccl_group, cuda_device, card_segments,
                                             monkeypatch):
    """Four shards on cuda:0 in an NCCL group of one process: each
    signature group is one graph on cuda:0 holding every shard's runners,
    the ``all_gather`` and the re-rank, captured under the sync debug mode
    set to raise; the replays make no call into ``torch.distributed`` and
    capture nothing; the fused, eager and plain runs equal each other and
    the same four shards with no group (the join on the host), docs
    exact, scores rtol 1e-5; K3's scored form launches inside the graphs."""
    from iresearch_tpu_torch import bench_mix
    from iresearch_tpu_torch.exec import batch as B
    from iresearch_tpu_torch.parallel import ShardedSearcher
    from iresearch_tpu_torch.parallel.multihost import dist_calls
    from iresearch_tpu_torch.search import filters as PF

    B.clear_fused_cache()
    term_at = bench_mix._ranked(card_segments[0])[0]
    filters = [f for _c, f in bench_mix.task_mix(card_segments[0])[::8]] + [
        PF.ByPhrase("body", [term_at(20), term_at(21)])]
    ss = ShardedSearcher(card_segments, group=nccl_group, devices=[cuda_device] * 4)
    assert ss.mesh.join_in_graph and (ss.mesh.world, ss.D, ss.joined) == (1, 4, True)
    assert [segs for _g, _d, segs in ss.shards] == [[0], [1], [2], []]
    want = ShardedSearcher(card_segments, devices=[cuda_device] * 4).prepare_many(
        filters, to_port(BM25()), wand=True, k_max=10).run(10)
    prep = ss.prepare_many(filters, to_port(BM25()), wand=True, k_max=10)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = prep.run(10)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    entries = [B._FUSED_KINDS["sharded"][prep.fused_key(gi, min(10, ss.nd_pad, g[3]))]
               for gi, g in enumerate(prep.groups)]
    assert all(len(e.passes) == 1 and e.passes[0].graph is not None
               and e.passes[0].device == cuda_device for e in entries)
    assert sum(e.passes[0].launches.get("decode_score_rows", 0) for e in entries) > 0
    captures = []
    real = B._FusedPass.capture
    monkeypatch.setattr(B._FusedPass, "capture",
                        lambda self, body: captures.append(self) or real(self, body))
    with dist_calls() as calls:
        again = prep.run(10)
        torch.cuda.synchronize()
    assert not calls and not captures and all(e.hits == 1 for e in entries)
    for other in (again, prep.run(10, fused=False), prep.run(10, plain=True), want):
        for g, w in zip(got, other):
            _agree(g, w)


def _topk_scores(rng, q, n, values):
    """f32 [q, n] rows: "random" (a third -inf), "ties" (four values),
    "zeros" (+-0.0 and +-1), "neg_inf" (all -inf), "few_finite" (40
    finite a row, fewer than k)."""
    if values == "random":
        x = rng.normal(size=(q, n)).astype(np.float32)
        x[rng.random((q, n)) < 0.3] = -np.inf
    elif values == "ties":
        x = rng.integers(0, 4, size=(q, n)).astype(np.float32)
    elif values == "zeros":
        x = rng.choice(np.asarray([0.0, -0.0, 1.0, -1.0], np.float32), size=(q, n))
    else:
        x = np.full((q, n), -np.inf, np.float32)
        if values == "few_finite":
            for r in range(q):
                x[r, rng.choice(n, 40, replace=False)] = rng.normal(size=40)
    return x


def _topk_docs(rng, q, n, form, dev):
    """docs [q, n] of a form: None (positions), a permutation a row as
    int32 or int64 (``int64_big``: above 2^40, so that IMAX - doc reaches
    the key's score half), ``dup`` (50 values: equal keys), ``expanded``
    (one row, stride 0) or ``strided`` (every other column of a wider
    array)."""
    if form is None:
        return None
    if form == "expanded":
        return torch.arange(n, dtype=torch.int32, device=dev).expand(q, n)
    if form == "dup":
        return torch.from_numpy(rng.integers(0, 50, size=(q, n)).astype(np.int32)).to(dev)
    wide = 2 if form == "strided" else 1
    d = np.stack([rng.permutation(wide * n) for _ in range(q)])
    if form == "int64_big":
        return torch.from_numpy(d + 2**40).to(dev)
    d = torch.from_numpy(d.astype(np.int64 if form == "int64" else np.int32)).to(dev)
    return d[:, ::2] if form == "strided" else d


# (Q, N, k, values, docs): the scan tier's two selects and the index
# pass's merge, each side of K4_MAX_K (the sort through device memory
# above it, one merge level and two), ragged and multi-launch rows,
# awkward values and every docs form
TOPK_CARD_CASES = {
    "scan_rescore": (80, 25_600, 100, "random", "int32"),
    "scan_rows": (80, 15_625, 200, "random", None),
    "merge": (80, 400, 100, "random", "int32"),
    "k1": (7, 5_000, 1, "random", None),
    "k_eq_n": (5, 777, 777, "ties", "int32"),
    "k4096": (3, 20_000, 4096, "random", "int64"),
    "k4097": (3, 20_000, 4097, "random", "int64"),
    "k9000_one_wide_row": (1, 2**20, 9000, "random", None),
    "k_eq_n_above_max": (3, 5_000, 5_000, "ties", "int32"),
    "equal_keys_above_max": (2, 20_000, 6_000, "ties", "dup"),
    "ragged_tiles": (4, 3 * 8192 + 7, 50, "random", None),
    "one_wide_row": (1, 2**21, 100, "random", None),
    "all_neg_inf": (6, 10_000, 100, "neg_inf", "int32"),
    "few_finite": (6, 30_000, 100, "few_finite", None),
    "heavy_ties": (8, 20_000, 300, "ties", "int32"),
    "signed_zero": (8, 9_000, 200, "zeros", "int32"),
    "equal_keys": (4, 12_000, 100, "ties", "dup"),
    "expanded": (16, 12_000, 100, "random", "expanded"),
    "strided": (16, 12_000, 100, "random", "strided"),
    "int64_big": (4, 10_000, 64, "random", "int64_big"),
}


def _same_topk(got, want):
    """Bit for bit: the values' f32 bits, the docs and their dtype."""
    assert got[1].dtype == want[1].dtype and got[0].shape == want[0].shape
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    assert torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(TOPK_CARD_CASES))
def test_topk_kernel_matches_plain_on_card(cuda_device, case):
    """K4 vs the key path (``topk_docs_ref``) on the same card tensors, bit
    for bit, with the launches ``_plan`` asks for and, above K4_MAX_K, the
    sort's."""
    from iresearch_tpu_torch.kernels import build as kb
    from iresearch_tpu_torch.ops import topk as tk

    q, n, k, values, form = TOPK_CARD_CASES[case]
    rng = np.random.default_rng(sorted(TOPK_CARD_CASES).index(case))
    scores = torch.from_numpy(_topk_scores(rng, q, n, values)).to(cuda_device)
    docs = _topk_docs(rng, q, n, form, cuda_device)
    before = kb.launch_counts()["topk_docs"]
    got = tk.topk_docs(scores, docs, k)
    torch.cuda.synchronize()
    launches = kb.launch_counts()["topk_docs"] - before
    assert launches == tk.launches(n, k) > 0
    _same_topk(got, tk.topk_docs_ref(scores, docs, k))


@pytest.mark.cuda
def test_topk_kernel_reads_strided_scores_on_card(cuda_device):
    """Scores that are every other column of a wider array, in two launches."""
    from iresearch_tpu_torch.ops import topk as tk

    rng = np.random.default_rng(5)
    wide = torch.from_numpy(_topk_scores(rng, 6, 2 * 20_000, "random")).to(cuda_device)
    scores = wide[:, ::2]
    _same_topk(tk.topk_docs(scores, None, 150), tk.topk_docs_ref(scores, None, 150))


@pytest.mark.cuda
def test_topk_kernel_in_captured_graph_on_card(cuda_device):
    """K4 inside a captured CUDA graph (one launch, two, and two with the
    sort above K4_MAX_K), replayed over new inputs copied into the captured
    buffers: each replay equals the key path on those inputs."""
    from iresearch_tpu_torch.ops import topk as tk

    rng = np.random.default_rng(9)
    scores = torch.from_numpy(_topk_scores(rng, 80, 25_600, "random")).to(cuda_device)
    docs = _topk_docs(rng, 80, 25_600, "int32", cuda_device)
    tk.topk_docs(scores, docs, 100)  # builds the library and allows its shared memory
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = (tk.topk_docs(scores, docs, 100), tk.topk_docs(scores[:, :400], None, 100),
               tk.topk_docs(scores[:4], docs[:4], 5000))
    for seed in (11, 12, 13):
        rng = np.random.default_rng(seed)
        scores.copy_(torch.from_numpy(_topk_scores(rng, 80, 25_600, "random")))
        docs.copy_(_topk_docs(rng, 80, 25_600, "int32", "cpu"))
        graph.replay()
        torch.cuda.synchronize()
        _same_topk(out[0], tk.topk_docs_ref(scores, docs, 100))
        _same_topk(out[1], tk.topk_docs_ref(scores[:, :400], None, 100))
        _same_topk(out[2], tk.topk_docs_ref(scores[:4], docs[:4], 5000))
