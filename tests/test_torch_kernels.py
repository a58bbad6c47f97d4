"""The three kernels' plain PyTorch versions vs the JAX package's Pallas
kernels (interpret mode on the CPU) and XLA twins, and the kernels
themselves vs their plain versions on the card (``cuda`` marker). Scorers
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


def test_wrappers_refuse_other_devices():
    """A wrapper runs its plain version only for CPU tensors."""
    t = torch.zeros((4, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        dg.dma_row_slices([t], torch.zeros((1, 1), dtype=torch.int32, device="meta"), 2)


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
