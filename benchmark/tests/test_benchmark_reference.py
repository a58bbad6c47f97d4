"""The plain reference against a brute-force loop, and the yardstick's
inputs (corpus, traffic) against themselves."""

import math

import numpy as np
import pytest
import torch

from benchmark import corpus as C
from benchmark.references import bm25
from benchmark.traffic import Query, QueryStream, band_terms, fixed_mix

LAW = {"vocab": 200, "zipf_s": 1.25, "doc_len": [5, 12]}


def brute(corp, q, k1=1.2, b=0.75, k=10):
    """Python loops over every doc of every segment: (docs, scores) of the
    top k by (score desc, doc asc)."""
    docs = []
    for seg, base in zip(corp.segments, corp.bases):
        tids, starts, lens = seg.tids.tolist(), seg.starts.tolist(), seg.lens.tolist()
        for d, (a, n) in enumerate(zip(starts, lens)):
            docs.append((base + d, tids[a : a + n]))
    n_docs = len(docs)
    avgdl = sum(len(t) for _d, t in docs) / n_docs
    df = {t: sum(1 for _d, toks in docs if t in toks) for t in q.terms}
    out = []
    for d, toks in docs:
        has = [t for t in q.terms if t in toks]
        if (q.op == "and" and len(has) < len(q.terms)) or not has:
            continue
        s = 0.0
        for t in has:
            tf = toks.count(t)
            idf = math.log1p((n_docs - df[t] + 0.5) / (df[t] + 0.5))
            s += (k1 + 1) * idf * tf / (tf + k1 * (1 - b + b * len(toks) / avgdl))
        out.append((-s, d))
    out.sort()
    return [d for _s, d in out[:k]], [-s for s, _d in out[:k]]


@pytest.mark.parametrize("sizes", [[300], [200, 90, 7]])
def test_reference_is_the_brute_force_loop(sizes):
    corp = C.generate(LAW, sizes, 99, "cpu")
    ref = bm25.BM25Reference(corp, 1.2, 0.75)
    queries = [Query("t", "term", (3,)), Query("t", "term", (150,)),
               Query("a", "and", (1, 7)), Query("a", "and", (0, 1, 2)),
               Query("o", "or", (2, 60)), Query("o", "or", (0, 5, 199))]
    for q in queries:
        want_d, want_s = brute(corp, q)
        docs, sc = ref.evaluate(q).top(10)
        assert docs.tolist() == want_d, q
        np.testing.assert_allclose(sc.numpy(), want_s, rtol=1e-12)


def test_corpus_and_traffic_follow_the_seed():
    a = C.generate(LAW, [100, 30], 2**31 + 5, "cpu")
    b = C.generate(LAW, [100, 30], 2**31 + 5, "cpu")
    c = C.generate(LAW, [100, 30], 2**31 + 6, "cpu")
    for sa, sb in zip(a.segments, b.segments):
        assert torch.equal(sa.tids, sb.tids) and torch.equal(sa.lens, sb.lens)
    assert not torch.equal(a.segments[0].tids[:50], c.segments[0].tids[:50])
    # another seed draws another corpus of the same work: the same doc
    # lengths and tokens a rank, other docs, positions and term ids
    for sa, sc in zip(a.segments, c.segments):
        assert not torch.equal(sa.lens, sc.lens)
        assert sorted(sa.lens.tolist()) == sorted(sc.lens.tolist())
        ca = torch.bincount(sa.tids, minlength=LAW["vocab"])
        cc = torch.bincount(sc.tids, minlength=LAW["vocab"])
        assert not torch.equal(ca, cc)
        assert sorted(ca.tolist()) == sorted(cc.tolist())
        want = C.term_counts(int(sa.lens.sum()), C.zipf_pmf(LAW["vocab"], LAW["zipf_s"]))
        assert sorted(ca.tolist()) == sorted(want.tolist())
    assert a.bases == [0, 100]
    lens = a.segments[0].lens
    assert int(lens.min()) >= 5 and int(lens.max()) < 12
    assert int(a.segments[0].tids.max()) < LAW["vocab"]

    df = C.doc_freqs(a)
    want = np.zeros(LAW["vocab"], np.int64)
    for seg in a.segments:
        for s, n in zip(seg.starts.tolist(), seg.lens.tolist()):
            for t in set(seg.tids[s : s + n].tolist()):
                want[t] += 1
    assert (df == want).all()
    ranked = C.ranked_terms(df)
    assert all(df[ranked[i]] >= df[ranked[i + 1]] for i in range(len(ranked) - 1))

    mix = {"bands": {"high": [0, 5], "low": [20, 30]},
           "categories": [{"name": "HighTerm", "op": "term", "bands": ["high"]},
                          {"name": "AndHighHigh", "op": "and", "bands": ["high", "high"]},
                          {"name": "OrHighLow", "op": "or", "bands": ["high", "low"]}],
           "per_category": 4}
    bands = band_terms(mix, ranked)
    s1 = QueryStream(mix, bands, 7, "window").draw(200)
    s2 = QueryStream(mix, bands, 7, "window").draw(200)
    s3 = QueryStream(mix, bands, 8, "window").draw(200)
    w = QueryStream(mix, bands, 7, "warmup").draw(200)
    assert s1 == s2 and s1 != s3 and s1 != w
    assert {q.category for q in s1} == {"HighTerm", "AndHighHigh", "OrHighLow"}
    assert all(len(set(q.terms)) == len(q.terms) for q in s1)
    fixed = fixed_mix(dict(mix, categories=[mix["categories"][0], mix["categories"][2]]), bands)
    assert [q.terms for q in fixed[:4]] == [(int(t),) for t in bands["high"][:4]]
    assert [q.terms for q in fixed[4:]] == [
        (int(h), int(lo)) for h, lo in zip(bands["high"][:4], bands["low"][:4])]


def test_fixed_mix_refuses_a_repeated_term():
    mix = {"bands": {"high": [0, 5]}, "per_category": 2,
           "categories": [{"name": "AndHighHigh", "op": "and", "bands": ["high", "high"]}]}
    with pytest.raises(ValueError, match="repeated"):
        fixed_mix(mix, {"high": np.arange(5)})


def test_the_yardstick_imports_nothing_of_the_program():
    """The reference and what it reads (corpus, traffic, comparison, byte
    counts, trace) import neither the program, nor the JAX package, nor
    jax: their module names are compared whole at the first dot."""
    import ast
    from pathlib import Path

    bench = Path(__file__).resolve().parents[1]
    files = [bench / f"{m}.py" for m in ("corpus", "traffic", "checks", "work", "trace")]
    files += sorted((bench / "references").glob("*.py"))
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for name in names:
                top = name.split(".")[0]
                assert top not in {"iresearch_tpu_torch", "iresearch_tpu", "jax", "jaxlib", "flax"}, (
                    path.name, name)
