"""The port's pyresearch facade (``iresearch_tpu_torch/pyresearch.py``) vs
the JAX package's, and the port's device-memory accounting
(``index/segment.py``) on the CPU.

Both facades walk the same index (written by the JAX package's writer and
by the port's) to the same fields, terms, postings and columns, and seek
the same terms. The accounting: an upload raises
``resource.manager().used("device")``, ``SegmentReader.invalidate_device()``
gives it back, and a limiter vetoes an upload, as in the JAX package
(``tests/test_pyresearch_api.py``); nothing vetoed stays resident.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from iresearch_tpu import pyresearch as jpy  # noqa: E402
from iresearch_tpu_torch import pyresearch as ppy  # noqa: E402
from iresearch_tpu_torch.utils import resource  # noqa: E402

WORDS = ["red", "fox", "dog", "sat", "ran", "blue", "füße", "北京"]


def _write(root, path):
    import importlib

    w = importlib.import_module(f"{root}.index.writer")
    d = importlib.import_module(f"{root}.store.directory").FSDirectory(str(path))
    rng = np.random.default_rng(4)
    opts = w.IndexWriterOptions(invert_backend="numpy", segment_docs_max=40)
    with w.IndexWriter(d, opts) as iw:
        for i in range(100):
            body = " ".join(WORDS[j] for j in rng.integers(0, len(WORDS), int(rng.integers(1, 9))))
            iw.insert([w.Field("body", body, analyzer="segmentation"),
                       w.Field("id", str(i), index=True, store=True)])
        iw.commit()
    return str(path)


@pytest.fixture(scope="module", params=["iresearch_tpu", "iresearch_tpu_torch"])
def index_path(request, tmp_path_factory):
    return _write(request.param, tmp_path_factory.mktemp("pyr"))


def _dump(py, path):
    """What the reference's python/scripts/index-dump.py reads."""
    index = py.index_reader.open(path)
    out = [("index", index.docs_count(), index.live_docs_count(), len(index))]
    for segment in index:
        out.append(("segment", segment.docs_count(), segment.live_docs_count()))
        for field in segment.fields():
            out.append(("field", field.name(), field.docs_count(), field.features(),
                        field.norm(), field.min(), field.max(), field.terms_count()))
            it = field.iterator()
            while it.next():
                docs = it.postings()
                got = []
                while docs.next():
                    got.append((docs.value(), docs.freq()))
                out.append((it.value(), got))
        for c in segment.columns():
            vals = segment.column(c.id())
            out.append(("column", c.name(), c.id(), list(vals), [vals[d] for d in vals]))
        assert segment.column(len(segment.columns())) is None
    return out


def test_index_dump_flow_matches_jax(index_path):
    got, want = _dump(ppy, index_path), _dump(jpy, index_path)
    assert got == want
    assert sum(1 for e in got if e[0] == "segment") == 3


def test_term_iterator_matches_jax(index_path):
    seqs = []
    for py in (ppy, jpy):
        seg = next(iter(py.index_reader.open(index_path)))
        it = seg.field("body").iterator()
        seq = [it.seek(b"red"), it.value(), it.seek("fox"), it.value()]
        for probe in (b"do", b"a", "füße", b"zzz", b"red"):
            r = it.seek_ge(probe)
            seq.append((r, it.value() if r != py.SEEK_END else None))
        seq.append(it.seek(b"nope"))
        it.seek(b"dog")
        d = it.postings()
        seq += [d.seek(0), d.value(), d.seek(50), d.seek(10**6)]
        seqs.append(seq)
        assert seg.field("nope") is None
    assert seqs[0] == seqs[1]
    assert (ppy.SEEK_NOT_FOUND, ppy.SEEK_FOUND, ppy.SEEK_END) == (0, 1, 2)


@pytest.fixture
def port_segment(tmp_path):
    from iresearch_tpu_torch.index.reader import DirectoryReader
    from iresearch_tpu_torch.store.directory import FSDirectory

    _write("iresearch_tpu_torch", tmp_path)
    return DirectoryReader.open(FSDirectory(str(tmp_path))).segments[0]


def test_device_memory_accounting(port_segment):
    from iresearch_tpu_torch.exec import DeviceQuery
    from iresearch_tpu_torch.search import filters as F

    sr = port_segment
    before = resource.manager().used(resource.CATEGORY_DEVICE)
    DeviceQuery(F.ByTerm("body", "red"), [sr], device="cpu").execute_segment(0, 5)
    after = resource.manager().used(resource.CATEGORY_DEVICE)
    df = sr.device_field("body", "cpu")
    assert after - before == df.device_bytes > 0
    assert sr.device("cpu") is sr.device("cpu") and sr.device("cpu").field("body") is df
    df.pos_words(0)  # a lazy pool counts on its first upload only
    df.pos_words(0)
    assert resource.manager().used(resource.CATEGORY_DEVICE) - before == df.device_bytes > after - before
    sr.invalidate_device()
    assert resource.manager().used(resource.CATEGORY_DEVICE) == before
    assert sr.device_field("body", "cpu") is not df  # uploaded anew
    sr.invalidate_device()
    assert resource.manager().used(resource.CATEGORY_DEVICE) == before


def test_limiter_vetoes_uploads(port_segment):
    sr = port_segment
    vetoes = []

    def limiter(cat, cur, delta):
        if cat == resource.CATEGORY_DEVICE and cur + delta > budget[0]:
            vetoes.append(delta)
            return False
        return True

    budget = [0]
    old = resource.set_manager(resource.ResourceManager(limiter=limiter))
    try:
        with pytest.raises(resource.ResourceLimitExceeded):
            sr.device_field("body", "cpu")
        assert resource.manager().used(resource.CATEGORY_DEVICE) == 0
        assert "body" not in sr.device("cpu")._fields  # nothing vetoed stays
        budget[0] = 1 << 40
        df = sr.device_field("body", "cpu")
        budget[0] = df.device_bytes
        with pytest.raises(resource.ResourceLimitExceeded):
            df.pos_words(0)
        assert 0 not in df._pos_words
        assert resource.manager().used(resource.CATEGORY_DEVICE) == df.device_bytes
        assert len(vetoes) == 2
        sr.invalidate_device()
        assert resource.manager().used(resource.CATEGORY_DEVICE) == 0
    finally:
        resource.set_manager(old)
        sr.invalidate_device()


def test_device_entry_needs_a_card(port_segment):
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port_segment.device()
