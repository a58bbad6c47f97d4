"""Analyzer implementations and the name->factory registry.

Reference: core/analysis/ — 13 registered analyzers configured from JSON
(text_token_stream.cpp:944-971, ngram_token_stream.hpp:37-120,
pipeline_token_stream.hpp:36, delimited_token_stream.hpp:37,
minhash_token_stream.hpp:33-75, ...). A copy of
``iresearch_tpu/analysis/analyzers.py``; it registers the same names. The
``classification`` and ``nearest_neighbors`` analyzers run the embedding
model of ``analysis/embed.py``.

Analyzers here are batch-oriented: ``tokenize(text)`` returns a token list;
the writer converts to flat (tid, doc, pos) arrays for device inversion.

The ``regex`` package is imported only where Unicode word segmentation
runs (``_word_re``): ASCII text through the ``segmentation`` analyzer takes
the native tokenizer and needs no ``regex``. Where the package is missing,
that call raises ``ImportError``; stdlib ``re`` does not stand in for it,
because its ``\\w`` differs on combining marks. The CJK class and the
literal delimiters of ``multi_delimiter`` match the same under stdlib
``re``.
"""

from __future__ import annotations

import json
import re
import unicodedata
from abc import ABC, abstractmethod
from typing import Callable, Dict, Iterable, List, Optional, Sequence

from iresearch_tpu_torch.analysis.token import Token

_WORD_RE = None


def _word_re():
    """Unicode word segmentation: the reference uses ICU BreakIterator
    (segmentation_token_stream.hpp:33); \\w+ over NFC text with the
    `regex` module's Unicode properties is our equivalent host
    segmentation. Compiled on first use."""
    global _WORD_RE
    if _WORD_RE is None:
        try:
            import regex as _regex
        except ImportError as e:
            raise ImportError(
                "Unicode word segmentation needs the 'regex' package "
                "(stdlib re's \\w differs on combining marks)"
            ) from e
        _WORD_RE = _regex.compile(r"[\w'']+", _regex.UNICODE)
    return _WORD_RE


# scripts the dictionary segmenter handles (analysis/cjk.py): Han, kana,
# Hangul — a regex "word" containing any of these is re-split there
_CJK_RE = re.compile(
    "[ᄀ-ᇿ〇぀-ヿㇰ-ㇿ"
    "㐀-䶿一-鿿가-힣]"
)

# Default English stopword list (the reference ships per-language lists and
# can load them from disk; this is the classic Snowball English set).
ENGLISH_STOPWORDS = frozenset(
    """i me my myself we our ours ourselves you your yours yourself yourselves
    he him his himself she her hers herself it its itself they them their
    theirs themselves what which who whom this that these those am is are was
    were be been being have has had having do does did doing a an the and but
    if or because as until while of at by for with about against between into
    through during before after above below to from up down in out on off
    over under again further then once here there when where why how all any
    both each few more most other some such no nor not only own same so than
    too very s t can will just don should now""".split()
)


class Analyzer(ABC):
    """A token stream factory: text -> tokens (term, position, offsets)."""

    name: str = "abstract"

    @abstractmethod
    def tokenize(self, text: str) -> List[Token]: ...

    def terms(self, text: str) -> List[bytes]:
        return [t.term for t in self.tokenize(text)]


class KeywordAnalyzer(Analyzer):
    """Whole input as a single token (reference: string_token_stream)."""

    name = "identity"

    def tokenize(self, text: str) -> List[Token]:
        data = text.encode("utf-8") if isinstance(text, str) else bytes(text)
        return [Token(data, 0, 0, len(text))]


class SegmentationAnalyzer(Analyzer):
    """Unicode word segmentation + case handling.

    Reference: segmentation_token_stream.hpp:33 (ICU BreakIterator;
    case option: lower/none/upper; word-break option alpha/all).
    """

    name = "segmentation"

    def __init__(self, case: str = "lower", word_break: str = "alpha") -> None:
        if case not in ("lower", "none", "upper"):
            raise ValueError(f"bad case option: {case}")
        if word_break not in ("alpha", "all", "graphic"):
            raise ValueError(f"bad break option: {word_break}")
        self._case = case
        self._word_break = word_break

    def bulk_tids(self, text: str, termdict):
        """Whole tokenize+term-lookup loop in C++ (ASCII input), appending
        into ``termdict``; None -> caller uses tokenize() per token."""
        if _CJK_RE.search(text):
            # CJK needs the dictionary word break (analysis/cjk.py); the
            # native alnum-run tokenizer would emit whole Han runs
            return None
        return termdict.tokenize_to_tids(text, self._case, self._word_break)

    def tokenize(self, text: str) -> List[Token]:
        # native C++ fast path for pure-ASCII input (native/iresearch_native
        # .cpp); identical output to the Unicode path below
        from iresearch_tpu_torch import native

        nat = native.tokenize_ascii(text, self._case, self._word_break)
        if nat is not None:
            buf, spans = nat
            return [
                Token(buf[s:e], pos, int(s), int(e))
                for pos, (s, e) in enumerate(spans)
            ]
        out = []
        pos = 0
        for m in _word_re().finditer(text):
            w = m.group(0).strip("'")
            if not w:
                continue
            if _CJK_RE.search(w):
                # dictionary-based CJK word break (analysis/cjk.py) —
                # the ICU BreakIterator CjkBreakEngine analog
                from iresearch_tpu_torch.analysis.cjk import split_word

                base = m.start() + m.group(0).index(w[0])
                for sub, rs, re_ in split_word(w) or ((w, 0, len(w)),):
                    if self._case == "lower":
                        sub = sub.lower()
                    elif self._case == "upper":
                        sub = sub.upper()
                    out.append(
                        Token(sub.encode("utf-8"), pos, base + rs, base + re_)
                    )
                    pos += 1
                continue
            if self._word_break == "alpha" and not any(c.isalpha() for c in w):
                # alpha mode keeps tokens containing letters; 'all' keeps
                # numerics too (reference: word/alpha/graphic modes)
                if not any(c.isdigit() for c in w):
                    continue
            if self._case == "lower":
                w = w.lower()
            elif self._case == "upper":
                w = w.upper()
            out.append(Token(w.encode("utf-8"), pos, m.start(), m.end()))
            pos += 1
        return out


class TextAnalyzer(Analyzer):
    """Segmentation + case + accent strip + locale stopwords + snowball
    stemming + optional edge-ngram emission.

    Reference: text_token_stream.hpp:45-85 (ICU locale segmentation, case
    folding, locale stopword removal, snowball stemming; JSON options at
    text_token_stream.cpp:423-429/802-811: locale, case, accent, stemming,
    stopwords, stopwordsPath, edgeNgram{min,max,preserveOriginal}).
    """

    name = "text"

    def __init__(
        self,
        locale: str = "en",
        stopwords: Optional[Iterable[str]] = None,
        stopwords_path: Optional[str] = None,
        stemming: bool = True,
        accent: bool = False,
        case: str = "lower",
        edge_ngram: Optional[dict] = None,
        no_stop_words: bool = False,
    ) -> None:
        from iresearch_tpu_torch.analysis import snowball as _snow
        from iresearch_tpu_torch.analysis.stopwords_data import STOPWORDS

        if case not in ("lower", "none", "upper"):
            raise ValueError(f"bad case option: {case}")
        self._locale = _snow.normalize_locale(locale)
        # stopword resolution order mirrors the reference
        # (text_token_stream.cpp:262-284): explicit list + path = union of
        # both; path only = from path (built-ins if the locale file is
        # absent); neither = built-in per-locale defaults.
        from iresearch_tpu_torch.analysis.stopwords_data import load_stopwords_path

        stop: Optional[frozenset] = None
        if stopwords is not None:
            stop = frozenset(stopwords)
        if stopwords_path:
            stop = (stop or frozenset()) | load_stopwords_path(
                stopwords_path, self._locale
            )
        if stop is None:
            if no_stop_words:
                stop = frozenset()
            else:
                stop = STOPWORDS.get(self._locale, frozenset())
        self._stopwords = stop
        self._stem = _snow.stemmer(locale) if stemming else None
        self._accent = accent  # True => keep accents
        self._case = case
        self._edge: Optional[tuple] = None
        if edge_ngram:
            mn = int(edge_ngram.get("min", 1))
            mx = int(edge_ngram.get("max", mn))
            self._edge = (mn, mx, bool(edge_ngram.get("preserveOriginal", False)))

    def _fold(self, w: str) -> str:
        if self._case == "lower":
            w = w.lower()
        elif self._case == "upper":
            w = w.upper()
        if not self._accent:
            w = "".join(
                c for c in unicodedata.normalize("NFD", w) if not unicodedata.combining(c)
            )
        return w

    def tokenize(self, text: str) -> List[Token]:
        out = []
        pos = 0
        for m in _word_re().finditer(text):
            w0 = m.group(0).strip("'")
            if w0 and _CJK_RE.search(w0):
                # locale-independent dictionary word break for CJK runs
                # (analysis/cjk.py); snowball has no CJK stemmers, so
                # sub-tokens skip stemming
                from iresearch_tpu_torch.analysis.cjk import split_word

                base = m.start() + m.group(0).index(w0[0])
                cands = [
                    (sub, base + rs, base + re_)
                    for sub, rs, re_ in (split_word(w0) or ())
                ]
            else:
                cands = [(w0, m.start(), m.end())]
            for w0c, cs, ce in cands:
                if self._emit(out, w0c, cs, ce, pos):
                    pos += 1
        return out

    def _emit(
        self, out: List[Token], w0: str, cs: int, ce: int, pos: int
    ) -> bool:
        """Fold/stop/stem/edge-ngram one word; True if token(s) emitted."""
        w = self._fold(w0)
        if not w or w in self._stopwords:
            return False
        if self._stem is not None and not _CJK_RE.search(w):
            w = self._stem(w)
        if not w:
            return False
        if self._edge is None:
            out.append(Token(w.encode("utf-8"), pos, cs, ce))
        else:
            # edge ngrams: prefixes of the (stemmed) token, all at the
            # token's position (reference: search-ngram mode,
            # text_token_stream.cpp:121)
            mn, mx, preserve = self._edge
            n = len(w)
            emitted = False
            for g in range(mn, min(mx, n) + 1):
                out.append(Token(w[:g].encode("utf-8"), pos, cs, ce))
                emitted = True
            if (preserve and n > mx) or not emitted:
                out.append(Token(w.encode("utf-8"), pos, cs, ce))
        return True


class NormAnalyzer(Analyzer):
    """Single-token case/accent normalization (reference: text_token_normalizing_stream.hpp:41)."""

    name = "norm"

    def __init__(self, case: str = "lower", accent: bool = True, locale: str = "en") -> None:
        # locale selects the ICU transliterator in the reference; Python's
        # str.lower/upper are Unicode-default-mapping equivalents
        self._locale = locale
        self._case = case
        self._accent = accent

    def tokenize(self, text: str) -> List[Token]:
        w = text
        if self._case == "lower":
            w = w.lower()
        elif self._case == "upper":
            w = w.upper()
        if not self._accent:
            w = "".join(
                c for c in unicodedata.normalize("NFD", w) if not unicodedata.combining(c)
            )
        return [Token(w.encode("utf-8"), 0, 0, len(text))]


class StemAnalyzer(Analyzer):
    """Single-token locale-parameterized stemming (reference:
    text_token_stemming_stream.hpp:42 — snowball by locale)."""

    name = "stem"

    def __init__(self, locale: str = "en") -> None:
        from iresearch_tpu_torch.analysis import snowball as _snow

        self._locale = _snow.normalize_locale(locale)
        self._stem = _snow.stemmer(locale) or (lambda w: w)

    def tokenize(self, text: str) -> List[Token]:
        return [Token(self._stem(text.lower()).encode("utf-8"), 0, 0, len(text))]


class DelimiterAnalyzer(Analyzer):
    """Split on a delimiter string (reference: delimited_token_stream.hpp:37)."""

    name = "delimiter"

    def __init__(self, delimiter: str = ",") -> None:
        self._delim = delimiter

    def tokenize(self, text: str) -> List[Token]:
        out = []
        start = 0
        pos = 0
        parts = text.split(self._delim) if self._delim else [text]
        for part in parts:
            if part:
                out.append(Token(part.encode("utf-8"), pos, start, start + len(part)))
                pos += 1
            start += len(part) + len(self._delim)
        return out


class MultiDelimiterAnalyzer(Analyzer):
    """Split on any of several delimiters (reference: multi_delimited_token_stream.hpp:41)."""

    name = "multi_delimiter"

    def __init__(self, delimiters: Sequence[str]) -> None:
        if not delimiters:
            raise ValueError("at least one delimiter required")
        self._re = re.compile("|".join(re.escape(d) for d in delimiters))

    def tokenize(self, text: str) -> List[Token]:
        out = []
        pos = 0
        last = 0
        for m in list(self._re.finditer(text)) + [None]:
            end = m.start() if m is not None else len(text)
            part = text[last:end]
            if part:
                out.append(Token(part.encode("utf-8"), pos, last, end))
                pos += 1
            if m is None:
                break
            last = m.end()
        return out


class NGramAnalyzer(Analyzer):
    """Character n-grams (reference: ngram_token_stream.hpp:37-120).

    Emits all n-grams with ``min_gram <= n <= max_gram``; n-grams starting at
    the same source offset share a position (position increment 0), matching
    the reference's increment semantics. ``preserve_original`` additionally
    emits the full input at position 0.
    """

    name = "ngram"

    def __init__(
        self,
        min_gram: int,
        max_gram: int,
        preserve_original: bool = False,
        start_marker: str = "",
        end_marker: str = "",
        stream_bytes: bool = False,
    ) -> None:
        if min_gram < 1 or max_gram < min_gram:
            raise ValueError("bad ngram bounds")
        self._min = min_gram
        self._max = max_gram
        self._preserve = preserve_original
        self._start_marker = start_marker
        self._end_marker = end_marker

    def tokenize(self, text: str) -> List[Token]:
        out = []
        n = len(text)
        emitted_original = False
        for i in range(n):
            pos = i  # all grams starting at i share position i
            for g in range(self._min, self._max + 1):
                if i + g > n:
                    break
                gram = text[i : i + g]
                marked = gram
                if i == 0 and self._start_marker:
                    marked = self._start_marker + gram
                if i + g == n and self._end_marker:
                    marked = marked + self._end_marker
                if i == 0 and i + g == n:
                    emitted_original = True
                out.append(Token(marked.encode("utf-8"), pos, i, i + g))
        if self._preserve and not emitted_original and n:
            out.insert(0, Token(text.encode("utf-8"), 0, 0, n))
        return out


class StopwordsAnalyzer(Analyzer):
    """Filter tokens of a wrapped analyzer (reference: token_stopwords_stream.hpp:38)."""

    name = "stopwords"

    def __init__(self, stopwords: Iterable[str], inner: Optional[Analyzer] = None) -> None:
        self._stop = frozenset(
            s.encode("utf-8") if isinstance(s, str) else bytes(s) for s in stopwords
        )
        self._inner = inner or KeywordAnalyzer()

    def tokenize(self, text: str) -> List[Token]:
        return [t for t in self._inner.tokenize(text) if t.term not in self._stop]


class PipelineAnalyzer(Analyzer):
    """Compose analyzers left-to-right (reference: pipeline_token_stream.hpp:36).

    Each downstream analyzer runs on the text of every upstream token;
    positions compose multiplicatively like the reference's pipeline
    (upstream position is the major axis).
    """

    name = "pipeline"

    def __init__(self, stages: Sequence[Analyzer]) -> None:
        if not stages:
            raise ValueError("pipeline requires at least one stage")
        self._stages = list(stages)

    def tokenize(self, text: str) -> List[Token]:
        tokens = [Token(text.encode("utf-8"), 0, 0, len(text))]
        for stage in self._stages:
            nxt: List[Token] = []
            pos = 0
            for tok in tokens:
                subs = stage.tokenize(tok.term.decode("utf-8", "replace"))
                last_sub_pos = None
                for s in subs:
                    if last_sub_pos is not None and s.position != last_sub_pos:
                        pos += s.position - last_sub_pos
                    nxt.append(Token(s.term, pos, tok.start, tok.end))
                    last_sub_pos = s.position
                pos += 1
            tokens = nxt
        return tokens


class CollationAnalyzer(Analyzer):
    """Collation sort key (reference: collation_token_stream.hpp:40).

    With a system ICU present the key is the locale-TAILORED binary
    sort key from ucol_getSortKey — byte order == collation order, so
    range queries over collation keys honor e.g. Swedish å/ä/ö > z
    (reference: collation_token_stream.cpp:65-80). Without ICU we fall
    back to an NFKD case-folded key (equal strings under
    locale-insensitive comparison map to equal terms; cross-term ORDER
    is only approximate) and bump a cap counter.
    """

    name = "collation"

    def __init__(self, locale: str = "en") -> None:
        self._locale = locale
        self._coll = None
        from iresearch_tpu_torch.analysis.icu import get_icu

        self._icu = get_icu()
        if self._icu is not None:
            self._coll = self._icu.collator(locale)

    def tokenize(self, text: str) -> List[Token]:
        if self._coll is not None:
            key = self._icu.sort_key(self._coll, text)
            return [Token(key, 0, 0, len(text))]
        from iresearch_tpu_torch.utils.metrics import registry

        registry().counter(
            "irs_collation_nfkd_fallback",
            help_="collation keys produced by the locale-INSENSITIVE "
            "NFKD fallback (no usable libicui18n in this image)",
        )
        key = unicodedata.normalize("NFKD", text).casefold().encode("utf-8")
        return [Token(key, 0, 0, len(text))]


class MinHashAnalyzer(Analyzer):
    """MinHash signatures of an inner stream (reference: minhash_token_stream.hpp:33-75)."""

    name = "minhash"

    def __init__(self, inner: Analyzer, num_hashes: int = 42) -> None:
        self._inner = inner
        self._k = num_hashes

    def tokenize(self, text: str) -> List[Token]:
        import hashlib

        terms = {t.term for t in self._inner.tokenize(text)}
        if not terms:
            return []
        hashes = []
        for term in terms:
            h = int.from_bytes(hashlib.blake2b(term, digest_size=8).digest(), "little")
            hashes.append(h)
        hashes.sort()
        sig = hashes[: self._k]
        return [
            Token(v.to_bytes(8, "little"), i, 0, len(text)) for i, v in enumerate(sig)
        ]


# --- registry ---------------------------------------------------------------

_REGISTRY: Dict[str, Callable[[dict], Analyzer]] = {}


def register(name: str, factory: Callable[[dict], Analyzer]) -> None:
    _REGISTRY[name] = factory


def registered() -> List[str]:
    return sorted(_REGISTRY)


def get(name: str, args: str | dict | None = None) -> Analyzer:
    """Create an analyzer by registered name from JSON/dict args.

    Mirrors ``analyzers::get(name, text_format::json, args)``. A registry
    miss consults $IRS_PLUGIN_PATH/libanalyzer-<name>.so before failing —
    the load_entry_from_so analog (reference register.hpp:78-117).
    """
    if name not in _REGISTRY:
        from iresearch_tpu_torch.utils.plugins import try_load_for_key

        if not try_load_for_key("analyzer", name):
            raise KeyError(
                f"unknown analyzer: {name!r} (have {registered()})"
            )
    if args is None:
        args = {}
    elif isinstance(args, str):
        args = json.loads(args) if args.strip() else {}
    return _REGISTRY[name](dict(args))


def _pipeline_factory(args: dict) -> Analyzer:
    stages = []
    for stage in args.get("pipeline", []):
        stages.append(get(stage["type"], stage.get("properties", {})))
    return PipelineAnalyzer(stages)


register("identity", lambda a: KeywordAnalyzer())
register(
    "segmentation",
    lambda a: SegmentationAnalyzer(
        case=a.get("case", "lower"), word_break=a.get("break", "alpha")
    ),
)
register(
    "text",
    lambda a: TextAnalyzer(
        locale=a.get("locale", "en"),
        stopwords=a.get("stopwords"),
        stopwords_path=a.get("stopwordsPath"),
        stemming=a.get("stemming", True),
        accent=a.get("accent", False),
        case=a.get("case", "lower"),
        edge_ngram=a.get("edgeNgram"),
    ),
)
register(
    "norm",
    lambda a: NormAnalyzer(
        case=a.get("case", "lower"),
        accent=a.get("accent", True),
        locale=a.get("locale", "en"),
    ),
)
register("stem", lambda a: StemAnalyzer(locale=a.get("locale", "en")))
register("delimiter", lambda a: DelimiterAnalyzer(a.get("delimiter", ",")))
register("multi_delimiter", lambda a: MultiDelimiterAnalyzer(a.get("delimiters", [","])))
register(
    "ngram",
    lambda a: NGramAnalyzer(
        min_gram=int(a.get("min", 2)),
        max_gram=int(a.get("max", 3)),
        preserve_original=bool(a.get("preserveOriginal", False)),
        start_marker=a.get("startMarker", ""),
        end_marker=a.get("endMarker", ""),
    ),
)
register("stopwords", lambda a: StopwordsAnalyzer(a.get("stopwords", [])))
register("pipeline", _pipeline_factory)
register("collation", lambda a: CollationAnalyzer(locale=a.get("locale", "en")))
register(
    "minhash",
    lambda a: MinHashAnalyzer(
        inner=get(a["analyzer"]["type"], a["analyzer"].get("properties", {}))
        if "analyzer" in a
        else SegmentationAnalyzer(),
        num_hashes=int(a.get("numHashes", 42)),
    ),
)


def _classification_factory(args: dict) -> Analyzer:
    """Reference: classification_stream.hpp:37 — JSON args
    model_location / top_k / threshold."""
    from iresearch_tpu_torch.analysis.embed import ClassificationAnalyzer, load_model

    return ClassificationAnalyzer(
        load_model(args["model_location"]),
        SegmentationAnalyzer(),
        top_k=int(args.get("top_k", 1)),
        threshold=float(args.get("threshold", 0.0)),
    )


def _nearest_neighbors_factory(args: dict) -> Analyzer:
    """Reference: nearest_neighbors_stream.hpp:38 — JSON args
    model_location / top_k."""
    from iresearch_tpu_torch.analysis.embed import NearestNeighborsAnalyzer, load_model

    return NearestNeighborsAnalyzer(
        load_model(args["model_location"]),
        SegmentationAnalyzer(),
        top_k=int(args.get("top_k", 1)),
    )


register("classification", _classification_factory)
register("nearest_neighbors", _nearest_neighbors_factory)
