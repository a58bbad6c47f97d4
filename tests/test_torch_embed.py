"""The port's embedding model (``iresearch_tpu_torch/analysis/embed.py``)
vs the JAX package's on the CPU.

The hashes, ``EmbeddingModel.predict``/``nearest``, the ``.npz`` files
(each package loads the other's), the fastText ``.bin`` loader (on a file
the test writes itself), ``train_supervised`` (its row matrices byte for
byte, its vectors to a tolerance, predictions and neighbours equal), the
``classification`` and ``nearest_neighbors`` analyzers through both
registries, and an index written with the ``classification`` analyzer
(files byte for byte). Training on the card against the CPU is marked
``cuda``.

Tolerance of the trained vectors: the port and the JAX package (XLA on
the CPU) start from the same values and take the same steps, but sum the
gather's backward and the means in other orders (on the card the
backward's ``index_add_`` adds atomically, in no fixed order), so the
vectors differ in the last bits and the differences grow over the steps.
The bound is ATOL + RTOL * |x| with ATOL 1e-5 and RTOL 1e-4; what was
found stays far below it: 2.4e-7 at most between the port and the JAX
package after 120 steps of the ``cuda`` case's corpus on the CPU, and
3.9e-7 and 5.7e-7 (two runs) between the card and the CPU after 120
steps on 2,000 docs of the bench corpus (``chip_smoke.py`` phase 15, an
NVIDIA H100 80GB HBM3 at 700 W). Rankings
(labels by probability, neighbours by cosine) are equal but where two
values lie within that bound of each other.
"""

import struct

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import iresearch_tpu.analysis as JA  # noqa: E402
import iresearch_tpu_torch.analysis as PA  # noqa: E402
from iresearch_tpu.analysis import embed as je  # noqa: E402
from iresearch_tpu_torch.analysis import embed as pe  # noqa: E402

ATOL, RTOL = 1e-5, 1e-4
LABELS = [b"__label__pos", b"__label__neg", b"__label__mix"]


def _words(n, seed):
    """Seeded words: ASCII, Latin-1 and CJK letters, 1-9 characters."""
    rng = np.random.default_rng(seed)
    alphabet = list("abcdefghijklmnopqrstuvwxyz") + list("äöüßé") + list("北京大学")
    return ["".join(rng.choice(alphabet, size=int(rng.integers(1, 10)))).encode()
            for _ in range(n)]


def _corpus(n_docs, seed=3):
    """(texts, labels): token lists over 60 seeded words; each label is a
    seeded function of the doc's tokens."""
    rng = np.random.default_rng(seed)
    vocab = _words(60, seed + 1)
    texts, labels = [], []
    for _ in range(n_docs):
        ids = rng.integers(0, len(vocab), size=int(rng.integers(0, 12)))
        texts.append([vocab[i] for i in ids])
        labels.append(LABELS[int(ids.sum()) % 3 if len(ids) else 0])
    return texts, labels


@pytest.fixture(scope="module")
def trained():
    """(texts, labels, JAX model, port model) of one small training run."""
    texts, labels = _corpus(150)
    kw = dict(dim=8, epochs=40, buckets=1 << 9)
    jm = je.train_supervised(texts, labels, **kw)
    pm = pe.train_supervised(texts, labels, device="cpu", **kw)
    return texts, labels, jm, pm


def test_hashes_match_jax():
    for w in _words(300, 7) + [b"", b"a", b"\xff\x80x"]:
        assert pe._fnv1a(w) == je._fnv1a(w)
        assert pe._ft_hash(w) == je._ft_hash(w)
        assert pe._subword_ngrams(w, 2, 5) == je._subword_ngrams(w, 2, 5)
        assert pe._ft_subword_hashes(w, 2, 5, 1 << 11) == je._ft_subword_hashes(
            w, 2, 5, 1 << 11)


def _model_pair(hash_kind):
    rng = np.random.default_rng(11)
    vocab = sorted(set(_words(40, 12)))
    buckets, dim = 64, 6
    inp = rng.standard_normal((len(vocab) + buckets, dim)).astype(np.float32)
    lv = rng.standard_normal((len(LABELS), dim)).astype(np.float32)
    args = (vocab, inp, LABELS, lv)
    kw = dict(minn=2, maxn=4, buckets=buckets, hash_kind=hash_kind)
    return je.EmbeddingModel(*args, **kw), pe.EmbeddingModel(*args, **kw), vocab


@pytest.mark.parametrize("hash_kind", ["fnv64", "ft32"])
def test_predict_and_nearest_match_jax(hash_kind):
    jm, pm, vocab = _model_pair(hash_kind)
    queries = vocab[:10] + _words(10, 13)  # in and out of the vocabulary
    for i in range(len(queries) - 3):
        words = queries[i : i + 3]
        assert pm.predict(words, k=3) == jm.predict(words, k=3)
        assert pm.predict(words, k=2, threshold=0.3) == jm.predict(words, k=2, threshold=0.3)
        np.testing.assert_array_equal(pm.text_vector(words), jm.text_vector(words))
    for w in queries:
        assert pm.nearest(w, k=4) == jm.nearest(w, k=4)


def test_npz_crosses_both_ways(tmp_path):
    jm, pm, _vocab = _model_pair("ft32")
    for src, dst, name in ((pm, je, "port.npz"), (jm, pe, "jax.npz")):
        path = str(tmp_path / name)
        src.save(path)
        back = dst.EmbeddingModel.load(path)
        assert back.vocab == src.vocab and back.labels == src.labels
        assert (back.minn, back.maxn, back.buckets, back.hash_kind) == (
            src.minn, src.maxn, src.buckets, src.hash_kind)
        np.testing.assert_array_equal(back.input_vectors, src.input_vectors)
        np.testing.assert_array_equal(back.label_vectors, src.label_vectors)


def _write_bin(path, words, labels, inp, out, bucket, minn, maxn):
    """A fastText ``.bin`` (FastText::saveModel layout, version 12)."""
    dim = inp.shape[1]
    buf = bytearray()
    buf += struct.pack("<ii", 793712314, 12)
    buf += struct.pack("<12i", dim, 5, 5, 1, 5, 1, 0, 3, bucket, minn, maxn, 100)
    buf += struct.pack("<d", 1e-4)
    buf += struct.pack("<3i", len(words) + len(labels), len(words), len(labels))
    buf += struct.pack("<2q", 1000, 0)
    for w in words:
        buf += w + b"\x00" + struct.pack("<qb", 10, 0)
    for lb in labels:
        buf += lb + b"\x00" + struct.pack("<qb", 5, 1)
    buf += b"\x00" + struct.pack("<2q", inp.shape[0], dim) + inp.tobytes()
    buf += b"\x00" + struct.pack("<2q", out.shape[0], dim) + out.tobytes()
    with open(path, "wb") as f:
        f.write(bytes(buf))


def test_fasttext_bin_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    words, bucket, dim = sorted(set(_words(20, 14))), 32, 4
    inp = rng.normal(size=(len(words) + bucket, dim)).astype(np.float32)
    out = rng.normal(size=(len(LABELS), dim)).astype(np.float32)
    path = str(tmp_path / "model.bin")
    _write_bin(path, words, LABELS, inp, out, bucket, 2, 3)
    pm, jm = pe.load_fasttext_bin(path), je.load_fasttext_bin(path)
    assert pm.vocab == jm.vocab == words and pm.labels == jm.labels
    assert pm.hash_kind == "ft32" and pm.buckets == bucket
    np.testing.assert_array_equal(pm.input_vectors, inp)
    np.testing.assert_array_equal(pm.label_vectors, jm.label_vectors)
    assert pe.load_model(path).vocab == words  # the magic, not the suffix, decides
    for w in words[:5] + _words(5, 15):
        np.testing.assert_array_equal(pm.word_vector(w), jm.word_vector(w))
        assert pm.predict([w], k=2) == jm.predict([w], k=2)
        assert pm.nearest(w, k=3) == jm.nearest(w, k=3)


def _jax_rows(model, texts):
    """The JAX package's row matrices (``embed.py:391-401``), as it builds
    them inside ``train_supervised``."""
    rows_per_doc = [
        [rid for w in t for rid in model._row_ids(w)] or [0] for t in texts
    ]
    maxr = max(len(r) for r in rows_per_doc)
    R = np.zeros((len(texts), maxr), np.int32)
    M = np.zeros((len(texts), maxr), np.float32)
    for i, r in enumerate(rows_per_doc):
        R[i, : len(r)] = r
        M[i, : len(r)] = 1.0
    return R, M


@pytest.mark.parametrize("min_count,minn", [(1, 3), (2, 3), (2, 0)])
def test_doc_rows_match_jax_byte_for_byte(trained, min_count, minn):
    """Empty docs, words out of the vocabulary (min_count 2) and words
    with no row at all (also no subwords: minn 0) included."""
    texts, _labels, jm, _pm = trained
    counts = {}
    for t in texts:
        for w in t:
            counts[w] = counts.get(w, 0) + 1
    vocab = sorted(w for w, c in counts.items() if c >= min_count)
    kw = dict(minn=minn, maxn=5, buckets=1 << 9)
    zeros = np.zeros((len(vocab) + (1 << 9), 4), np.float32)
    model_j = je.EmbeddingModel(vocab, zeros, [], None, **kw)
    model_p = pe.EmbeddingModel(vocab, zeros, [], None, **kw)
    texts = texts + [[], [b"zzzz-unseen"]]
    R, M = pe.doc_rows(model_p, texts)
    Rj, Mj = _jax_rows(model_j, texts)
    assert R.dtype == Rj.dtype and M.dtype == Mj.dtype
    assert R.tobytes() == Rj.tobytes() and M.tobytes() == Mj.tobytes()


def test_train_supervised_matches_jax(trained):
    texts, labels, jm, pm = trained
    assert pm.vocab == jm.vocab and pm.labels == jm.labels
    np.testing.assert_allclose(pm.input_vectors, jm.input_vectors, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(pm.label_vectors, jm.label_vectors, atol=ATOL, rtol=RTOL)
    assert pm.losses.shape == (40,) and pm.losses[-1] < pm.losses[0]
    np.testing.assert_allclose(pm.losses[0], np.log(3.0), rtol=1e-6)
    agree = 0
    for t, lab in zip(texts, labels):
        got, want = pm.predict(t, k=3), jm.predict(t, k=3)
        _same_ranking(got, want, t)
        agree += got[0][0] == lab
    assert agree > len(texts) / 3  # above chance: it learned something
    for w in pm.vocab[:25]:
        _same_ranking(pm.nearest(w, k=3), jm.nearest(w, k=3), w)


def _same_ranking(got, want, what):
    """The same names in the same order, but for neighbours whose values
    (probabilities, cosines) lie within the vectors' tolerance of each
    other, which may swap."""
    assert len(got) == len(want), what
    for i, ((g, gv), (w, wv)) in enumerate(zip(got, want)):
        assert abs(gv - wv) <= ATOL + RTOL * abs(wv), what
        if g != w:
            near = [v for _n, v in want[max(0, i - 1) : i + 2]]
            assert max(near) - min(near) <= 2 * (ATOL + RTOL * abs(wv)), what


@pytest.fixture(scope="module")
def model_path(trained, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("embed") / "model.npz")
    trained[3].save(path)
    return path


@pytest.mark.parametrize("name,args", [
    ("classification", {"top_k": 2}),
    ("classification", {"top_k": 3, "threshold": 0.3}),
    ("nearest_neighbors", {"top_k": 2}),
])
def test_embed_analyzers_match_jax(trained, model_path, name, args):
    args = dict(args, model_location=model_path)
    pa, ja = PA.get(name, args), JA.get(name, args)
    assert type(pa).__name__ == type(ja).__name__
    for t in trained[0][:40]:
        text = " ".join(w.decode() for w in t)
        got = [(k.term, k.position, k.start, k.end) for k in pa.tokenize(text)]
        want = [(k.term, k.position, k.start, k.end) for k in ja.tokenize(text)]
        assert got == want, text


def test_classification_index_matches_jax(trained, model_path):
    """An index with a ``classification`` field: files byte for byte."""
    from iresearch_tpu.index.writer import Field as JField, IndexWriter as JWriter
    from iresearch_tpu.index.writer import IndexWriterOptions as JOpts
    from iresearch_tpu.store.directory import MemoryDirectory as JDir
    from iresearch_tpu_torch.index.writer import Field, IndexWriter, IndexWriterOptions
    from iresearch_tpu_torch.store.directory import MemoryDirectory

    args = {"model_location": model_path, "top_k": 2}
    texts = [" ".join(w.decode() for w in t) for t in trained[0][:60]]
    pd, jd = MemoryDirectory(), JDir()
    with IndexWriter(pd, IndexWriterOptions(segment_docs_max=32), device="cpu") as w:
        for t in texts:
            w.insert([Field("label", t, analyzer=PA.get("classification", args)),
                      Field("body", t, analyzer="segmentation")])
        w.commit()
    with JWriter(jd, JOpts(segment_docs_max=32)) as w:
        for t in texts:
            w.insert([JField("label", t, analyzer=JA.get("classification", args)),
                      JField("body", t, analyzer="segmentation")])
        w.commit()
    names = sorted(jd.list())
    assert sorted(pd.list()) == names and len(names) > 2
    for name in names:
        assert bytes(pd.read(name)) == bytes(jd.read(name)), name


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_train_on_card_matches_cpu(cuda_device):
    """The module defaults (120 steps) on the card against the CPU."""
    texts, labels = _corpus(400, seed=5)
    kw = dict(dim=16, buckets=1 << 11)
    cm = pe.train_supervised(texts, labels, device=cuda_device, **kw)
    hm = pe.train_supervised(texts, labels, device="cpu", **kw)
    np.testing.assert_allclose(cm.input_vectors, hm.input_vectors, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(cm.label_vectors, hm.label_vectors, atol=ATOL, rtol=RTOL)
    for t in texts:
        _same_ranking(cm.predict(t, k=3), hm.predict(t, k=3), t)
