"""The port's index lifecycle (``iresearch_tpu_torch/index/{writer,reader,
merge,consolidate,features}.py``) vs the JAX package on the CPU.

The same seeded documents and operations go through both packages'
``IndexWriter``; every file of the two directories (segment files, doc
masks, ``segments_<gen>``) must be equal byte for byte. The cases cover
several fields, stored values, OFFS/PAY, a primary sort, feature columns,
a remove and a replace by filter, rollbacks, flushes inverted on the host
(``invert_backend="numpy"``) and on the device (the port's ``"device"``
and its default ``"auto"`` run ``invert_device`` on ``device="cpu"``; the
JAX package's ``"device"`` runs its jitted inversion on its CPU backend),
and consolidation with and without deletes.

``test_ingest_in_small_equals_bench_segment`` is ``chip_smoke.py``'s
phase 13 at 20,000 docs: the writer's index of the ``bench_mix`` corpus
as text, flushed at 16,384 docs and consolidated, equals
``bench_mix.build_segment_data`` in every array and in its file bytes,
and after a delete it serves the 400-query mix through
``QueryBatch.prepare_all`` as the numpy oracle does.
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from iresearch_tpu_torch import bench_mix  # noqa: E402

ROOTS = ("iresearch_tpu", "iresearch_tpu_torch")
WORDS = ["alpha", "beta", "gamma", "delta", "eps", "zeta", "eta", "theta",
         "iota", "kappa", "lambda", "mu", "füße", "naïve", "北京大学", "w3"]


class Pkg:
    """One package's writer-side modules, by import root."""

    def __init__(self, root):
        self.root = root
        mod = lambda name: importlib.import_module(f"{root}.{name}")  # noqa: E731
        self.w = mod("index.writer")
        self.r = mod("index.reader")
        self.cons = mod("index.consolidate")
        self.F = mod("search.filters")
        self.spec = mod("formats.spec")
        self.dirs = mod("store.directory")
        self.an = mod("analysis.analyzers")
        self.tok = mod("analysis.token")

    def writer(self, d, backend, **opts):
        o = self.w.IndexWriterOptions(invert_backend=backend, **opts)
        if self.root == "iresearch_tpu_torch" and backend != "numpy":
            return self.w.IndexWriter(d, o, device="cpu")
        return self.w.IndexWriter(d, o)

    def payload_analyzer(self):
        """Space split; payload = the upper-cased token bytes."""
        Token = self.tok.Token

        class PayloadAnalyzer(self.an.Analyzer):
            def tokenize(self, text):
                out, off = [], 0
                for pos, w in enumerate(text.split()):
                    start = text.index(w, off)
                    off = start + len(w)
                    out.append(Token(w.encode(), pos, start, off, w.upper().encode()))
                return out

        return PayloadAnalyzer()


JAX, PORT = Pkg(ROOTS[0]), Pkg(ROOTS[1])


def _docs(n, seed):
    """(body, title, tag, price) per doc, from a seed."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        body = " ".join(WORDS[int(i)] for i in rng.zipf(1.6, int(rng.integers(1, 12))) % len(WORDS))
        title = " ".join(WORDS[int(i)] for i in rng.integers(0, 8, int(rng.integers(1, 5))))
        out.append((body, title, f"tag{int(rng.integers(0, 6))}", int(rng.integers(-50, 50))))
    return out


def _fields(p, doc, pay):
    body, title, tag, price = doc
    spec = p.spec.IndexFeatures
    return [
        p.w.Field("body", body, analyzer="segmentation", feature_columns=("norm", "norm2")),
        p.w.Field("title", title, analyzer=pay,
                  features=spec.FREQ | spec.POS | spec.OFFS | spec.PAY),
        p.w.Field("tag", tag, store=True),
        p.w.Field("price", price, analyzer="numeric", store=True),
        p.w.Field("note", body.upper(), index=False, store=True),
    ]


def _price_key(b):
    return int.from_bytes(b, "little", signed=True)


def run_case(p, case, backend):
    """The case's operations through package ``p``; returns its directory."""
    d = p.dirs.MemoryDirectory()
    pay = p.payload_analyzer()
    docs = _docs(160, 5)
    opts = dict(segment_docs_max=48)
    if case == "sort":
        opts["sort"] = p.w.SortSpec("price", key=_price_key, descending=True)
    with p.writer(d, backend, **opts) as w:
        for i, doc in enumerate(docs[:100]):
            w.insert(_fields(p, doc, pay))
            if i == 70:
                w.commit()
        if case == "deletes":
            w.remove(p.F.ByTerm("body", "w3"))
            with w.batch() as tx:
                tx.replace(p.F.ByTerm("tag", "tag2"), _fields(p, docs[100], pay))
                tx.insert(_fields(p, docs[101], pay))
            w.remove(p.F.And(p.F.ByTerm("body", "alpha"), p.F.ByTerm("title", "beta")))
        if case == "rollback":
            w.commit()
            for doc in docs[100:120]:
                w.insert(_fields(p, doc, pay))
            w.remove(p.F.ByTerm("tag", "tag1"))
            w.rollback()
            with pytest.raises(RuntimeError):
                with w.batch() as tx:
                    tx.insert(_fields(p, docs[120], pay))
                    raise RuntimeError("abandon the transaction")
        for doc in docs[121:160]:
            w.insert(_fields(p, doc, pay))
        w.commit()
    return d


def assert_same_files(pd, jd):
    names = sorted(jd.list())
    assert sorted(pd.list()) == names
    for name in names:
        assert bytes(pd.read(name)) == bytes(jd.read(name)), name


@pytest.mark.parametrize("backend", ["numpy", "device"])
@pytest.mark.parametrize("case", ["fields", "sort", "deletes", "rollback"])
def test_writer_files_match_jax(case, backend):
    pd, jd = run_case(PORT, case, backend), run_case(JAX, case, backend)
    assert_same_files(pd, jd)
    r = PORT.r.DirectoryReader.open(pd)
    assert len(r.segments) >= 3
    if case == "deletes":
        assert any(sr.has_deletes for sr in r.segments)
    if case == "rollback":
        assert r.live_docs_count == 100 + 39


def test_auto_backend_equals_numpy():
    """The port's default ``"auto"`` inverts on the writer's device; the
    files equal the host inversion's."""
    assert PORT.w.IndexWriterOptions().invert_backend == "auto"
    assert_same_files(run_case(PORT, "deletes", "auto"), run_case(PORT, "deletes", "numpy"))


@pytest.mark.parametrize("deletes", [False, True], ids=["live", "deletes"])
def test_consolidation_files_match_jax(deletes):
    dirs = []
    for p in (PORT, JAX):
        d = run_case(p, "deletes" if deletes else "fields", "numpy")
        with p.writer(d, "numpy", segment_docs_max=48) as w:
            assert w.consolidate(p.cons.consolidate_count())
            if deletes:  # a remove after the merge lands on the merged segment
                w.remove(p.F.ByTerm("body", "beta"))
                w.commit()
        dirs.append(d)
    assert_same_files(*dirs)
    r = PORT.r.DirectoryReader.open(dirs[0])
    assert len(r.segments) == 1 and r.segments[0].has_deletes == deletes


def test_reader_matches_jax():
    pd, jd = run_case(PORT, "deletes", "numpy"), run_case(JAX, "deletes", "numpy")
    pr, jr = PORT.r.DirectoryReader.open(pd), JAX.r.DirectoryReader.open(jd)
    assert pr.meta.to_bytes() == jr.meta.to_bytes()
    assert (pr.docs_count, pr.live_docs_count) == (jr.docs_count, jr.live_docs_count)
    assert pr.field_stats("body") == jr.field_stats("body")
    for term in (b"alpha", b"w3", "北京大学".encode()):
        assert pr.term_stats("body", term) == jr.term_stats("body", term)
    for g in range(0, pr.docs_count, 7):
        assert pr.split_doc(g) == jr.split_doc(g)
        assert pr.stored(g, "tag") == jr.stored(g, "tag")
        assert pr.stored(g, "note") == jr.stored(g, "note")
    assert pr.reopen() is pr


def test_no_device_without_a_card():
    """``"auto"`` and ``"device"`` invert on the card unless a device is
    named, and raise on a host without one; ``"numpy"`` needs none. A
    reader preloads onto the card unless a device is named."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    d = PORT.dirs.MemoryDirectory()
    for backend in ("auto", "device"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            PORT.w.IndexWriter(d, PORT.w.IndexWriterOptions(invert_backend=backend))
    with pytest.raises(ValueError, match="invert_backend"):
        PORT.w.IndexWriter(d, PORT.w.IndexWriterOptions(invert_backend="tpu"))
    with PORT.w.IndexWriter(d, PORT.w.IndexWriterOptions(invert_backend="numpy")) as w:
        w.insert([PORT.w.Field("body", "a b c", analyzer="segmentation")])
        w.commit()
    opts = PORT.r.ReaderOptions(preload_fields=("body",))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PORT.r.DirectoryReader.open(d, opts)
    PORT.r.DirectoryReader.open(d)  # no preload: no device touched
    r = PORT.r.DirectoryReader.open(d, opts, device="cpu")
    from iresearch_tpu_torch.index.segment import device_state

    assert device_state(r.segments[0], "cpu")._fields.keys() == {"body"}


# --- chip_smoke.py's phase 13, in small -----------------------------------

N_SMALL = 20_000
SEED = bench_mix.SEED + 1


@pytest.fixture(scope="module")
def ingested():
    """(2-segment reader, consolidated reader, reader after the delete,
    the removed term)."""
    buf, starts, ends = bench_mix.corpus_text(N_SMALL, SEED)
    d = PORT.dirs.MemoryDirectory()
    w = PORT.w.IndexWriter(d, PORT.w.IndexWriterOptions(segment_docs_max=16_384),
                           device="cpu")
    for s, e in zip(starts.tolist(), ends.tolist()):
        w.insert([PORT.w.Field("body", buf[s:e].decode(), analyzer="segmentation")])
    w.commit()
    two = PORT.r.DirectoryReader.open(d)
    assert w.consolidate(PORT.cons.consolidate_count())
    one = PORT.r.DirectoryReader.open(d)
    # the df-rank-2000 term: the mix's first LowTerm query
    term = next(f.term for c, f in bench_mix.task_mix(one.segments[0]) if c == "LowTerm")
    w.remove(PORT.F.ByTerm("body", term))
    w.commit()
    w.close()
    return two, one, PORT.r.DirectoryReader.open(d), term, d


def test_ingest_in_small_equals_bench_segment(ingested):
    from iresearch_tpu_torch.formats.segment_io import write_segment

    two, one, _deleted, _term, _d = ingested
    assert [sr.num_docs for sr in two.segments] == [16_384, N_SMALL - 16_384]
    assert [sr.num_docs for sr in one.segments] == [N_SMALL]
    want = bench_mix.build_segment_data(N_SMALL, SEED)
    got = one.segments[0].data
    assert list(got.fields) == ["body"] and not got.columns
    gf, wf = got.fields["body"], want.fields["body"]
    import dataclasses

    for f in dataclasses.fields(wf):
        a, b = getattr(gf, f.name), getattr(wf, f.name)
        pairs = zip(a, b) if isinstance(b, (tuple, list)) else [(a, b)]
        if isinstance(b, (tuple, list)):
            assert len(a) == len(b), f.name
        for x, y in pairs:
            if isinstance(y, np.ndarray):
                assert x.dtype == y.dtype, f.name
                np.testing.assert_array_equal(x, y, err_msg=f.name)
            elif isinstance(y, (bytes, bytearray, memoryview)):
                assert bytes(x) == bytes(y), f.name
            else:
                assert x == y, f.name
    assert bytes(write_segment(want)) == bytes(write_segment(got))


def test_ingested_index_serves_as_the_oracle(ingested):
    """The written index after a delete, through ``prepare_all(10).run()``
    on the CPU, against the numpy oracle (``host_eval.search``): docs
    exact, scores rtol 1e-5; the removed docs never come back."""
    from iresearch_tpu_torch.exec.batch import QueryBatch
    from iresearch_tpu_torch.search.host_eval import search
    from iresearch_tpu_torch.search.scorers import BM25

    _two, _one, reader, term, _d = ingested
    sr = reader.segments[0]
    assert sr.has_deletes and len(reader.segments) == 1
    dead = set(np.flatnonzero(~sr.alive).tolist())
    tasks = bench_mix.task_mix(sr)
    assert len(tasks) == 400
    filters = [f for _c, f in tasks]
    gone = [qi for qi, f in enumerate(filters) if f == PORT.F.ByTerm("body", term)]
    assert gone == [160]  # the first LowTerm query
    vals, docs = (t.numpy() for t in QueryBatch(filters, reader.segments, BM25(), wand=True,
                                                device="cpu").prepare_all(10).run())
    assert np.flatnonzero(~np.isfinite(vals[:, 0])).tolist() == gone
    for qi, flt in enumerate(filters):
        ref = search(reader, flt, BM25(), 10)
        fin = np.isfinite(vals[qi])
        np.testing.assert_array_equal(docs[qi][fin], [d for d, _v in ref], err_msg=f"q{qi}")
        np.testing.assert_allclose(vals[qi][fin], [v for _d, v in ref], rtol=1e-5, atol=0.0)
        assert not dead & set(docs[qi][fin].tolist())
