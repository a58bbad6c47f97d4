"""The port's benchmark entry points (``iresearch_tpu_torch/bench.py``,
``bench_build.py``, ``bench_micro.py``) against the JAX package on the
CPU, at a small size with short windows.

``bench.run`` over ``bench.py``'s corpus as one 3,000-doc segment and as
two (6,000 docs, ``BENCH_SEG_DOCS`` 3,000): its batched pass and each
breadth category's single query hold against the JAX package's
``QueryBatch(...).search`` over the same segment files, which the JAX
package reads through its own ``formats/segment_io.read_segment`` (docs
exact after the JAX output is put in (score desc, doc asc) order, ROADMAP
deliberate difference e; scores to rtol 1e-5). ``bench_build.run`` indexes the same
docs as the JAX package's ``IndexWriter``, term for term. Each module's
``python -m`` entry fails at once without a card, and none of them loads
``jax`` or ``iresearch_tpu``. The ``cuda`` test runs ``bench.run`` at
50,000 docs on the card and holds its batched pass against the same pass
through the kernels' plain versions.
"""

import ast
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from iresearch_tpu.exec.batch import QueryBatch as JaxQueryBatch  # noqa: E402
from iresearch_tpu.formats.segment_io import read_segment as jax_read_segment  # noqa: E402
from iresearch_tpu.index.segment import SegmentReader as JaxSegmentReader  # noqa: E402
from iresearch_tpu.search.scorers import BM25  # noqa: E402
from iresearch_tpu_torch import bench, bench_build, bench_micro, bench_mix  # noqa: E402
from test_torch_carry import to_jax  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K = bench.K
WINDOWS = bench.Windows(lat_runs=2, pct_runs=2, reps=1, hot_reps=1, calib_passes=1,
                        batched_s=0.0, serve_s=0.0)
LINE_KEYS = {"metric", "value", "unit", "device", "power_limit_w", "failed"}


def _quiet(*_a):
    pass


def _jax_segments(cache, num_docs, seg_docs):
    """The JAX package's readers over the segment files that
    ``bench.load_index`` wrote, found by ``bench.py``'s file names."""
    out = []
    for si, n in enumerate(bench.segment_sizes(num_docs, seg_docs)):
        suffix = "" if si == 0 else f"_s{bench_mix.SEED + si}"
        with open(os.path.join(cache, f"seg_{n}_{bench_mix.VOCAB}_v5{suffix}.bin"), "rb") as f:
            out.append(JaxSegmentReader(f"bench{si}", jax_read_segment(f.read())))
    return out


@pytest.fixture(scope="module", params=[(3000, 3000), (6000, 3000)],
                ids=["one_segment", "two_segments"])
def bench_run(request, tmp_path_factory):
    """(the port's ``bench.run`` result, its segments, the JAX readers of
    the same segment files)."""
    num_docs, seg_docs = request.param
    cache = str(tmp_path_factory.mktemp("bench_cache"))
    srs = bench.load_index(num_docs, seg_docs, cache, log=_quiet)
    assert [sr.num_docs for sr in srs] == bench.segment_sizes(num_docs, seg_docs)
    res = bench.run(srs, device="cpu", windows=WINDOWS, verify_merge=True, log=_quiet)
    return res, srs, _jax_segments(cache, num_docs, seg_docs)


def _assert_same_topk(gv, gd, want, what):
    """The port's row (vals, global docs in (score desc, doc asc) order,
    -inf for non-matches) against the JAX package's hits [(global doc,
    score)], put in that order: the same matches, docs exact, scores to
    rtol 1e-5."""
    gv, gd = np.asarray(gv), np.asarray(gd)
    wd = np.array([d for d, _v in want], np.int64)
    wv = np.array([v for _d, v in want], np.float32)
    o = np.lexsort((wd, -wv))
    wv, wd = wv[o], wd[o]
    fin = np.isfinite(gv)
    assert int(fin.sum()) == len(wv), (what, int(fin.sum()), len(wv))
    np.testing.assert_array_equal(gd[fin], wd, err_msg=what)
    np.testing.assert_allclose(gv[fin], wv, rtol=1e-5, atol=0.0, err_msg=what)


def test_batched_pass_equals_jax(bench_run):
    res, _srs, jsegs = bench_run
    vals, docs = res.batched
    assert vals.shape == docs.shape == (len(res.tasks), K)
    want = JaxQueryBatch([to_jax(f) for _c, f in res.tasks], jsegs, BM25(),
                         wand=True).search(K)
    for qi, (cat, _f) in enumerate(res.tasks):
        _assert_same_topk(vals[qi], docs[qi], want[qi], f"q{qi} {cat}")


def test_breadth_categories_equal_jax(bench_run):
    res, srs, jsegs = bench_run
    cats = bench_mix.breadth_tasks(srs[0], res.line["docs"])
    assert [c for c, _f, _w in cats] == list(res.single)
    for wand in (False, True):
        mine = [(c, f) for c, f, w in cats if w == wand]
        want = JaxQueryBatch([to_jax(f) for _c, f in mine], jsegs, BM25(),
                             wand=wand).search(K)
        for qi, (cat, _f) in enumerate(mine):
            _assert_same_topk(*res.single[cat], want[qi], cat)


def test_last_line(bench_run):
    """The last line's object: its keys, no failed category, the CPU named
    as the device, and every number of the run in it."""
    res, srs, _jsegs = bench_run
    line = json.loads(json.dumps(res.line))
    assert LINE_KEYS <= set(line)
    assert (line["metric"], line["unit"]) == ("bm25_top10_qps_single_chip", "queries/sec")
    assert line["device"] == "cpu" and line["power_limit_w"] is None
    assert line["failed"] == []
    assert line["value"] > 0 and line["serving_qps"] > 0
    assert line["docs"] == sum(sr.num_docs for sr in srs) and line["segments"] == len(srs)
    assert set(line["categories_ms"]) == set(res.single)
    assert "vs_baseline" not in line


def test_breadth_failure_is_named(tmp_path):
    """A breadth category that raises (here its filter is not the port's)
    is logged by name and listed in ``failed``; the measurements after it go
    on."""
    srs = bench.load_index(1000, 1000, str(tmp_path), log=_quiet)
    said = []
    real_mix, real_breadth = bench_mix.task_mix, bench_mix.breadth_tasks
    # a short mix (two queries a category) keeps the passes after it cheap
    bench_mix.task_mix = lambda sr: real_mix(sr)[::40]
    bench_mix.breadth_tasks = lambda sr, num_docs=None: [
        real_breadth(sr, num_docs)[3], ("Broken", object(), False)]
    try:
        res = bench.run(srs, device="cpu", windows=WINDOWS, log=lambda *a: said.append(a[0]))
    finally:
        bench_mix.task_mix, bench_mix.breadth_tasks = real_mix, real_breadth
    assert res.line["failed"] == ["Broken"] and list(res.single) == ["AndHighLow"]
    assert any(s.startswith("Broken: FAILED") for s in said)
    assert any("QPS (completion-synced)" in s for s in said)


def test_bench_without_card_fails_at_once():
    """``python -m iresearch_tpu_torch.bench`` where PyTorch sees no card
    (its malloc re-exec included): a non-zero exit within seconds that says
    so, and no JSON line."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, "-m", "iresearch_tpu_torch.bench"], cwd=REPO,
                       env=env, capture_output=True, text=True, timeout=120)
    took = time.perf_counter() - t0
    assert p.returncode != 0
    assert "no CUDA device" in p.stderr
    assert not any(line.startswith("{") for line in p.stdout.splitlines())
    assert took < 30, took


@pytest.mark.parametrize("module", [bench, bench_build, bench_micro],
                         ids=["bench", "bench_build", "bench_micro"])
def test_main_without_card_builds_nothing(module, monkeypatch, capsys):
    """Each module's ``main()`` asks for the card before it builds anything:
    where PyTorch sees none it returns 1 at once, says so and prints
    nothing to stdout."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    t0 = time.perf_counter()
    assert module.main() == 1
    assert time.perf_counter() - t0 < 1.0
    out = capsys.readouterr()
    assert "no CUDA device" in out.err and out.out == ""


@pytest.fixture(scope="module")
def micro_rows():
    """A fresh interpreter imports the three modules and runs
    ``bench_micro.run`` on the CPU: (row names, modules of jax or
    iresearch_tpu loaded)."""
    code = (
        "import json, sys\n"
        "import iresearch_tpu_torch.bench, iresearch_tpu_torch.bench_build\n"
        "from iresearch_tpu_torch import bench_micro\n"
        "names = [n for n, _t in bench_micro.run(device='cpu')]\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'iresearch_tpu'))\n"
        "print(json.dumps([names, bad]))\n"
    )
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(p.stdout.splitlines()[-1])


def test_bench_modules_import_no_jax(micro_rows):
    assert micro_rows[1] == []


def _jax_row_names():
    """The row names of the repo's ``bench_micro.py``, read from its source
    (importing it would run JAX): the first item of each ``rows.append``,
    its f-string over the WAND modes expanded."""
    with open(os.path.join(REPO, "bench_micro.py")) as f:
        tree = ast.parse(f.read())
    names = []
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "append" and isinstance(node.func.value, ast.Name)
                and node.func.value.id == "rows"):
            first = node.args[0].elts[0]
            if isinstance(first, ast.Constant):
                names.append((node.lineno, [first.value]))
            else:  # f"wand ... [{mode}]" in a loop over the three modes
                text = ast.unparse(first)[2:-1]
                names.append((node.lineno, [text.replace("{mode}", m)
                                            for m in ("exact", "strict", "approx")]))
    return [n for _l, ns in sorted(names) for n in ns]


def test_micro_rows_are_jax_rows(micro_rows):
    """The same rows, in the same order and under the same names (the
    native rows where the shared library loads, as here)."""
    assert micro_rows[0] == _jax_row_names()


def _terms_and_dfs(segments):
    """{field: {term: df}} summed over the segments."""
    out = {}
    for sr in segments:
        for field, fp in sr.data.fields.items():
            terms = sr.terms(field)
            dfs = out.setdefault(field, {})
            for i in range(len(terms)):
                t = bytes(terms[i])
                dfs[t] = dfs.get(t, 0) + int(fp.entries[i, 0])
    return out


def test_bench_build_matches_jax_writer():
    """Two indexer threads and the committer index every doc: the live doc
    count and each field's terms with their dfs equal the JAX package's
    ``IndexWriter`` over the same 500 docs."""
    from iresearch_tpu.index.reader import DirectoryReader
    from iresearch_tpu.index.writer import Field, IndexWriter, IndexWriterOptions
    from iresearch_tpu.store.directory import MemoryDirectory

    res = bench_build.run(num_docs=500, threads=2, device="cpu", log=_quiet)
    assert res.line["metric"] == "index_build_docs_per_sec" and res.line["value"] > 0
    assert res.line["device"] == "cpu" and res.line["docs"] == 500
    docs, total = bench_build.corpus(500)
    assert res.line["tokens"] == total
    d = MemoryDirectory()
    with IndexWriter(d, IndexWriterOptions(invert_backend="numpy",
                                           segment_docs_max=1 << 20)) as w:
        for j, text in enumerate(docs):
            w.insert([Field("body", text, analyzer="segmentation"),
                      Field("id", str(j), index=True, store=True)])
        w.commit()
    want = DirectoryReader.open(d)
    assert res.reader.live_docs_count == want.live_docs_count == 500
    got, exp = _terms_and_dfs(res.reader.segments), _terms_and_dfs(want.segments)
    assert set(got) == set(exp) == {"body", "id"}
    for field in exp:
        assert got[field] == exp[field], field


@pytest.mark.cuda
@pytest.mark.parametrize("seg_docs", [50_000, 25_000], ids=["one_segment", "two_segments"])
def test_bench_on_card_equals_plain(seg_docs, tmp_path):
    """``bench.run`` at 50,000 docs on the card: its batched pass equals the
    same pass with every kernel wrapper forced to its plain version (docs
    equal, scores to rtol 1e-5), and K1, K2 and K3's scored form launched
    in the run."""
    from iresearch_tpu_torch.kernels import build as kb

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    srs = bench.load_index(50_000, seg_docs, str(tmp_path), log=_quiet)
    kb.reset_launch_counts()
    res = bench.run(srs, device="cuda", windows=WINDOWS, verify_merge=True, log=_quiet)
    launches = kb.launch_counts()
    for name in ("dense_scan_rowmax", "dma_row_slices", "decode_score_rows"):
        assert launches[name] > 0, launches
    assert res.line["failed"] == [] and res.line["device"] == torch.cuda.get_device_name(0)
    vals, docs = res.batched
    if len(srs) == 1:
        pv, pd = bench._rows(res.prepared.run_grouped(plain=True), len(res.tasks), K)
    else:
        pv, pd = (t.cpu().numpy() for t in res.prepared.run(plain=True))
    np.testing.assert_array_equal(docs, pd)
    np.testing.assert_allclose(vals, pv, rtol=1e-5, atol=0.0)
