"""The port's analyzers (``iresearch_tpu_torch/analysis``) vs the JAX
package's on the CPU.

Every analyzer that both packages register, and that needs no model file,
tokenizes the same inputs into the same stream: term bytes, position,
offsets and payload, token for token. The inputs are drawn from
``tests/test_analysis.py``, ``test_cjk.py``, ``test_multilang.py``,
``test_snowball_vendored.py`` and ``test_numeric_ngram.py``; the vendored
snowball stemmers are also held against each other on seeded random
words. ``classification`` and ``nearest_neighbors`` need an embedding
model: ``tests/test_torch_embed.py`` holds them against the JAX package.
"""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import iresearch_tpu.analysis as JA
import iresearch_tpu_torch.analysis as PA
from iresearch_tpu.analysis import analyzers as jan
from iresearch_tpu_torch.analysis import analyzers as pan

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TEXTS = [
    "The quick brown fox jumps over the lazy dog",
    "foo bar",
    "AbC running runs happiness",
    "Füße gehen aufeinander; Katzen laufen, Hunde und Bäume",
    "continuellement les chevaux nationale à Paris",
    "книгами красивая говорить ёлками",
    "corriendo nacionales comieron correndo felizmente gatti lopende",
    "我们在北京大学 hello WORLD",
    "我们在北京大学学习自然语言处理",
    "去东京スカイツリー",
    "running 北京大学",
    "한국어 텍스트 烎烎烎",
    "don't stop 'quoted' O'Brien",
    "école café x2 42 3.14 snake_case",
    "a,b,,c;d||e.f*g",
    "Ünïcode wörds — dash… tab\tnew\nline",
    "",
    "   ",
]
NUMBERS = ["42", "-7", "0", "3.25", "-2.5e3", "1e300", "9223372036854775807"]

# (args, inputs) per registered analyzer
CONFIGS = {
    "identity": [({}, TEXTS)],
    "segmentation": [
        ({}, TEXTS),
        ({"case": "none"}, TEXTS),
        ({"case": "upper", "break": "all"}, TEXTS),
        ({"break": "graphic"}, TEXTS),
    ],
    "text": [
        ({}, TEXTS),
        ({"locale": "en", "stemming": False, "stopwords": []}, TEXTS),
        ({"stopwords": ["foo"], "stemming": False}, TEXTS),
        ({"locale": "de_DE.UTF-8"}, TEXTS),
        ({"locale": "fr", "accent": True, "stemming": False}, TEXTS),
        ({"locale": "ru"}, TEXTS),
        ({"locale": "es"}, TEXTS),
        ({"locale": "nl", "case": "none"}, TEXTS),
        ({"locale": "zz"}, TEXTS),
        ({"edgeNgram": {"min": 2, "max": 4, "preserveOriginal": True}}, TEXTS),
    ],
    "norm": [({}, TEXTS), ({"case": "upper", "accent": False}, TEXTS)],
    "stem": [({"locale": loc}, TEXTS) for loc in ("en", "de", "fr", "ru", "pt", "zz")],
    "delimiter": [({"delimiter": ","}, TEXTS), ({"delimiter": ";"}, TEXTS)],
    "multi_delimiter": [
        ({"delimiters": [",", ";", "||"]}, TEXTS),
        ({"delimiters": [".", "*", " "]}, TEXTS),
    ],
    "ngram": [
        ({"min": 2, "max": 3}, TEXTS),
        ({"min": 2, "max": 2, "preserveOriginal": True}, TEXTS),
        ({"min": 1, "max": 2, "startMarker": "^", "endMarker": "$"}, TEXTS),
    ],
    "stopwords": [({"stopwords": ["the", "foo", "x"]}, TEXTS)],
    "pipeline": [
        ({"pipeline": [{"type": "delimiter", "properties": {"delimiter": ","}},
                       {"type": "segmentation"}]}, TEXTS),
        ({"pipeline": [{"type": "text", "properties": {"locale": "de"}},
                       {"type": "ngram", "properties": {"min": 2, "max": 2}}]}, TEXTS),
    ],
    "collation": [({"locale": loc}, TEXTS) for loc in ("en", "sv", "de")],
    "minhash": [
        ({"numHashes": 8}, TEXTS),
        ({"analyzer": {"type": "text", "properties": {"locale": "en"}}, "numHashes": 4}, TEXTS),
    ],
    "numeric": [({}, NUMBERS), ({"step": 8}, NUMBERS)],
}
EMBED = ("classification", "nearest_neighbors")


def _stream(analyzer, text):
    return [(t.term, t.position, t.start, t.end, t.payload) for t in analyzer.tokenize(text)]


def test_registered_names_match_jax():
    """Both packages register the same names when imported alone (in this
    process, other test modules add their own to the JAX registry)."""
    code = ("import json, iresearch_tpu.analysis as J, iresearch_tpu_torch.analysis as P; "
            "print(json.dumps([J.registered(), P.registered()]))")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    jax_names, port_names = json.loads(r.stdout.splitlines()[-1])
    assert port_names == jax_names
    assert set(port_names) == set(CONFIGS) | set(EMBED)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_analyzer_stream_matches_jax(name):
    for args, inputs in CONFIGS[name]:
        pa, ja = PA.get(name, args), JA.get(name, args)
        assert type(pa).__name__ == type(ja).__name__
        for text in inputs:
            assert _stream(pa, text) == _stream(ja, text), (name, args, text)


def test_json_args_match_jax():
    args = '{"delimiter": ";"}'
    assert _stream(PA.get("delimiter", args), "a;b;;c") == _stream(
        JA.get("delimiter", args), "a;b;;c")
    with pytest.raises(KeyError):
        PA.get("nope")


def _words(rng, alphabet, suffixes, n):
    out = []
    for _ in range(n):
        stem = "".join(rng.choice(list(alphabet), size=int(rng.integers(2, 8))))
        out.append(stem + (suffixes[int(rng.integers(len(suffixes)))]
                           if rng.random() < 0.8 else ""))
    return out


@pytest.mark.parametrize("lang", ["german", "french", "russian", "english"])
def test_vendored_stemmers_match_jax(lang):
    from iresearch_tpu.analysis import porter2 as jp2
    from iresearch_tpu.analysis import snowball_impl as ji
    from iresearch_tpu_torch.analysis import porter2 as pp2
    from iresearch_tpu_torch.analysis import snowball_impl as pi

    from test_snowball_vendored import DE_SUFFIXES, FR_SUFFIXES, RU_SUFFIXES

    alphabet, suffixes, pf, jf = {
        "german": ("abdeghiklmnorstuäöüß", DE_SUFFIXES, pi.stem_german, ji.stem_german),
        "french": ("abcdeilmnorstuéèêàç", FR_SUFFIXES, pi.stem_french, ji.stem_french),
        "russian": ("абвгдежзиклмнопрстуфхцчшщыьэюяё", RU_SUFFIXES,
                    pi.stem_russian, ji.stem_russian),
        "english": ("abcdefghilmnoprstuvwy", ["ing", "ness", "ational", "ies", "ed",
                                              "ly", "ization", "fulness", "s", ""],
                    pp2.stem, jp2.stem),
    }[lang]
    words = _words(np.random.default_rng(7), alphabet, suffixes, 3000)
    assert [pf(w) for w in words] == [jf(w) for w in words]


def test_numeric_terms_match_jax():
    from iresearch_tpu.analysis import numeric as jn
    from iresearch_tpu_torch.analysis import numeric as pn

    vals = [-(2**62), -5, -1, 0, 1, 7, 2**62, -1e300, -2.5, -0.0, 0.0, 1e-10, 3.14, 1e300]
    for step in (4, 8, 16):
        for v in vals:
            assert pn.numeric_terms(v, step) == jn.numeric_terms(v, step)
        u = pn.sortable_u64(12345)
        assert [pn.level_term(u, s) for s in range(0, 64, step)] == [
            jn.level_term(u, s) for s in range(0, 64, step)]


def test_cjk_split_matches_jax():
    from iresearch_tpu.analysis import cjk as jc
    from iresearch_tpu_torch.analysis import cjk as pc

    assert (pc.lexicon() is None) == (jc.lexicon() is None)
    for text in TEXTS + ["北京的天气很好", "大学生活非常充实", "他们在清华大学研究计算机"]:
        assert pc.has_cjk(text) == jc.has_cjk(text)
        assert pc.split_word(text) == jc.split_word(text), text


def test_word_segmentation_needs_regex(monkeypatch):
    """Without the ``regex`` package, Unicode word segmentation raises an
    ImportError that names it (no stdlib ``re`` stand-in); ASCII text
    through ``segmentation`` still takes the native tokenizer."""
    monkeypatch.setitem(sys.modules, "regex", None)
    monkeypatch.setattr(pan, "_WORD_RE", None)
    seg = PA.get("segmentation")
    want = _stream(JA.get("segmentation"), TEXTS[0])
    from iresearch_tpu_torch import native

    if native.load() is not None:
        assert _stream(seg, TEXTS[0]) == want
    with pytest.raises(ImportError, match="'regex'"):
        seg.tokenize("Füße gehen")
    with pytest.raises(ImportError, match="'regex'"):
        PA.get("text").tokenize("plain ascii text")


def test_plugin_analyzer_matches_jax(tmp_path, monkeypatch):
    """A plugin library found on a registry miss ($IRS_PLUGIN_PATH,
    ``utils/plugins.py``) tokenizes the same in both packages."""
    if shutil.which("g++") is None:
        pytest.skip("no C++ compiler")
    so = tmp_path / "libanalyzer-shout.so"
    subprocess.check_call(["g++", "-shared", "-fPIC", "-O2", "-o", str(so),
                           os.path.join(REPO, "native", "sample_plugin.cpp")])
    import iresearch_tpu.utils.plugins as jpl
    import iresearch_tpu_torch.utils.plugins as ppl

    for an, pl in ((jan, jpl), (pan, ppl)):
        monkeypatch.setattr(an, "_REGISTRY", dict(an._REGISTRY))
        monkeypatch.setattr(pl, "_LOADED", {})
    monkeypatch.setenv("IRS_PLUGIN_PATH", str(tmp_path))
    got = _stream(PA.get("shout"), "hello plugin world")
    assert got == _stream(JA.get("shout"), "hello plugin world")
    assert [t[0] for t in got] == [b"HELLO", b"PLUGIN", b"WORLD"]
    assert ppl.load_plugins(str(tmp_path), prefix="libanalyzer-") == ["shout"]
