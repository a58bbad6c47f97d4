"""The port's CLI (``iresearch_tpu_torch/cli``) vs the JAX package's on the
CPU.

``put`` by both packages on one line-docs file (the ``bench_mix`` corpus
as text) writes the same files byte for byte; the task file of all 22
categories (``bench_mix.task_lines``) parses into the same tasks and
filters (compared through ``to_port``); ``search`` with both engines
gives the hits of the JAX package's oracle (the exactness gate), and its
output lines have the JAX CLI's form; ``dump`` prints the same lines;
``convert`` writes the same bytes in every direction of
``tests/test_format_versions.py``'s matrix; ``__main__`` dispatches. The
port takes ``--device cpu`` here; ``search --engine device`` on the card
is marked ``cuda``.
"""

import contextlib
import io

import pytest

torch = pytest.importorskip("torch")

from iresearch_tpu.cli import index_search as jsearch  # noqa: E402
from iresearch_tpu_torch import bench_mix  # noqa: E402
from iresearch_tpu_torch.cli import index_search as psearch  # noqa: E402
from test_torch_carry import to_port  # noqa: E402
from topk_util import assert_topk_equiv  # noqa: E402

DOCS = 1500


def _files(path):
    from iresearch_tpu.store.directory import FSDirectory

    d = FSDirectory(str(path))
    return {name: bytes(d.read(name)) for name in sorted(d.list())}


@pytest.fixture(scope="module")
def linedocs(tmp_path_factory):
    buf, starts, ends = bench_mix.corpus_text(DOCS, seed=9)
    path = tmp_path_factory.mktemp("corpus") / "lines.txt"
    with open(path, "w") as f:
        for i, (s, e) in enumerate(zip(starts.tolist(), ends.tolist())):
            f.write(f"Title {i}\t2012-05-02\t{buf[s:e].decode()}\n")
    return path


def _put_args(linedocs, d):
    return ["--in", str(linedocs), "--index-dir", str(d), "--threads", "1",
            "--batch-size", "200", "--segment-docs-max", "512", "--consolidate"]


@pytest.fixture(scope="module")
def indexes(linedocs, tmp_path_factory):
    """(JAX-written dir, port-written dir) of the same ``put``."""
    from iresearch_tpu.cli.index_put import main as jput
    from iresearch_tpu_torch.cli.index_put import main as pput

    jd, pd = tmp_path_factory.mktemp("jput"), tmp_path_factory.mktemp("pput")
    assert jput(_put_args(linedocs, jd)) == 0
    assert pput(_put_args(linedocs, pd) + ["--device", "cpu"]) == 0
    return jd, pd


def test_put_writes_jax_files(indexes):
    jd, pd = indexes
    want = _files(jd)
    assert list(_files(pd)) == list(want) and len(want) > 2
    for name, blob in _files(pd).items():
        assert blob == want[name], name


@pytest.fixture(scope="module")
def tasks(indexes):
    from iresearch_tpu_torch.index.reader import DirectoryReader
    from iresearch_tpu_torch.store.directory import FSDirectory

    reader = DirectoryReader.open(FSDirectory(str(indexes[1])))
    lines = bench_mix.task_lines(reader.segments[0], per_category=2)
    return lines + ["Garbage line", "UnknownCat: xyz", "HighTerm: extra # 1"]


def test_tasks_and_filters_match_jax(tasks):
    got = psearch.parse_tasks(tasks, 2)
    assert got == jsearch.parse_tasks(tasks, 2)
    assert sorted({c for c, _t in got}) == sorted(psearch.CATEGORIES) == sorted(jsearch.CATEGORIES)
    assert len(got) == 44
    for cat, text in got:
        for limit in (16, 3):
            want = jsearch.build_filter(cat, text, limit)
            assert want is not None, (cat, text)
            assert psearch.build_filter(cat, text, limit) == to_port(want), (cat, text)
    assert psearch.split_freq("a b # 3") == jsearch.split_freq("a b # 3")


def _search_args(tmp_path, tasks, index_dir, engine, *extra):
    path = tmp_path / "bench.tasks"
    path.write_text("\n".join(tasks) + "\n")
    return ["--in", str(path), "--index-dir", str(index_dir), "--engine", engine,
            "--topN", "10", "--max-tasks", "2", *extra]


@pytest.mark.parametrize("engine", ["device", "host"])
def test_search_matches_jax_oracle(indexes, tasks, tmp_path, engine):
    """Each task's hits from the port's engine against the JAX package's
    ``host_eval.search`` on the same index (the JAX engines give the
    oracle's ranking)."""
    from iresearch_tpu.index.reader import DirectoryReader as JReader
    from iresearch_tpu.search.host_eval import search as jhost
    from iresearch_tpu.search.scorers import BM25
    from iresearch_tpu.store.directory import FSDirectory as JFS
    from iresearch_tpu_torch.index.reader import DirectoryReader
    from iresearch_tpu_torch.search.scorers import get_scorer
    from iresearch_tpu_torch.store.directory import FSDirectory

    jd, pd = indexes
    args = psearch.parse_args(_search_args(tmp_path, tasks, pd, engine, "--device", "cpu"))
    reader = DirectoryReader.open(FSDirectory(str(pd)))
    stats, results = psearch.run_tasks(args, reader, psearch.parse_tasks(tasks, 2),
                                       get_scorer("bm25", {}))
    assert {c: n for c, (n, _s) in stats.items()} == {c: 2 for c in psearch.CATEGORIES}
    jreader = JReader.open(JFS(str(jd)))
    for (cat, text), hits in results.items():
        want = jhost(jreader, jsearch.build_filter(cat, text, 16), BM25(), k=10)
        assert_topk_equiv(hits, want)
    # in a corpus this small only the rarer phrases and the n-grams, whose
    # terms the task file takes from rarer bands, may find nothing
    empty = {cat for (cat, _t), hits in results.items() if not hits}
    assert empty <= {"LowPhrase", "MedPhrase", "HighNGram", "MedNGram", "LowNGram"}, empty


def _run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


def test_search_output_lines_match_jax(indexes, tasks, tmp_path, monkeypatch):
    """The CSV (one line per category) and the metrics file have the JAX
    CLI's form; the text report names every category and three samples.
    Each package's metrics registry is a process-wide one: both start
    empty here, as in a fresh ``search`` process."""
    import iresearch_tpu.utils.metrics as jmetrics
    import iresearch_tpu_torch.utils.metrics as pmetrics

    for mod in (jmetrics, pmetrics):
        monkeypatch.setattr(mod, "_registry", mod.MetricsRegistry())
    jd, pd = indexes
    short = [t for t in tasks if t.split(":")[0] in ("HighTerm", "OrHighMed", "Prefix3")]
    outs = []
    for main, d, extra in ((jsearch.main, jd, []), (psearch.main, pd, ["--device", "cpu"])):
        metrics = tmp_path / f"m{len(outs)}.prom"
        rc, csv, err = _run(main, _search_args(tmp_path, short, d, "host", "--csv",
                                               "--metrics-out", str(metrics), *extra))
        assert rc == 0
        rc, text, _err = _run(main, _search_args(tmp_path, short, d, "host", *extra))
        assert rc == 0
        outs.append((csv, err, text, metrics.read_text()))
    (jcsv, jerr, jtext, jm), (pcsv, perr, ptext, pm) = outs
    strip = lambda s: [ln.split(",")[:2] for ln in s.splitlines()]  # noqa: E731
    assert strip(pcsv) == strip(jcsv) and pcsv.splitlines()[0] == "category,calls,time_us,avg_us"
    assert perr == jerr
    assert [ln.split(":")[0] for ln in ptext.splitlines()] == [
        ln.split(":")[0] for ln in jtext.splitlines()]
    metric_names = lambda s: sorted(ln.split(" ")[0] for ln in s.splitlines())  # noqa: E731
    assert metric_names(pm) == metric_names(jm)


def test_dump_prints_jax_lines(indexes):
    from iresearch_tpu.cli.index_dump import main as jdump
    from iresearch_tpu_torch.cli.index_dump import main as pdump

    for d in indexes:
        for argv in (["--postings", "--positions", "--columns", "--max-terms", "5"],
                     ["--field", "title", "--max-terms", "3"]):
            argv = ["--index-dir", str(d)] + argv
            got, want = _run(pdump, argv), _run(jdump, argv)
            assert got == want and got[0] == 0 and f"{DOCS} docs" in got[1]


@pytest.mark.parametrize(
    "src,dst", [(3, 4), (4, 3), (4, 5), (5, 4), (3, 5), (5, 3), (5, 6), (6, 5),
                (3, 6), (6, 3), (6, 7), (7, 6), (3, 7), (7, 3)])
def test_convert_writes_jax_bytes(tmp_path, src, dst):
    """``tests/test_format_versions.py``'s matrix: the JAX package writes
    the source index, both CLIs convert it; the outputs are equal byte
    for byte and open to the same hits."""
    import test_format_versions as tfv
    from iresearch_tpu.cli.index_convert import main as jconvert
    from iresearch_tpu.store.directory import FSDirectory
    from iresearch_tpu_torch.cli.index_convert import main as pconvert

    versions = {v: getattr(tfv, f"FORMAT_V{v}") for v in (3, 4, 5, 6, 7)}
    a, jb, pb = tmp_path / "a", tmp_path / "jb", tmp_path / "pb"
    a.mkdir()
    tfv._build(FSDirectory(str(a)), versions[src])
    argv = ["--in", str(a), "--format", versions[dst]]
    rj = _run(jconvert, argv + ["--out", str(jb)])
    rp = _run(pconvert, argv + ["--out", str(pb), "--device", "cpu"])
    assert rp == rj and rp[0] == 0 and "1 segments, 120 docs" in rp[1]
    want = _files(jb)
    assert list(_files(pb)) == list(want)
    for name, blob in _files(pb).items():
        assert blob == want[name], name
        if name.endswith(".seg"):
            assert versions[dst].encode() in blob


def test_main_dispatches(indexes, capsys):
    from iresearch_tpu_torch.cli.__main__ import main

    argv = ["--index-dir", str(indexes[1]), "--max-terms", "1"]
    for form in (["dump"], ["-m", "dump"]):
        assert main(form + argv) == 0
        assert "field body" in capsys.readouterr().out
    assert main(["nope"]) == 2 and main([]) == 2
    assert "python -m iresearch_tpu_torch.cli {put|search|dump|convert}" in capsys.readouterr().err


@pytest.mark.cuda
def test_search_device_engine_on_card(indexes, tasks, tmp_path):
    """``search --engine device`` on the card against the host engine."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    from iresearch_tpu_torch.index.reader import DirectoryReader
    from iresearch_tpu_torch.search.scorers import get_scorer
    from iresearch_tpu_torch.store.directory import FSDirectory

    reader = DirectoryReader.open(FSDirectory(str(indexes[1])))
    parsed = psearch.parse_tasks(tasks, 2)
    got, want = (
        psearch.run_tasks(psearch.parse_args(_search_args(tmp_path, tasks, indexes[1], e)),
                          reader, parsed, get_scorer("bm25", {}))[1]
        for e in ("device", "host"))
    assert list(got) == list(want)
    for key, hits in got.items():
        assert_topk_equiv(hits, want[key])
