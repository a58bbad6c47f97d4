"""Dictionary-driven CJK word segmentation.

Reference: the `segmentation` / `text` analyzers use ICU BreakIterator
(segmentation_token_stream.hpp:33), whose CJK handling is a
dictionary-based engine (ICU CjkBreakEngine): within a Han run it picks
the word sequence maximizing unigram log-probability over a frequency
lexicon (cjdict). This module implements the same objective directly: a
Viterbi DP over a frequency lexicon, with out-of-vocabulary characters
given a smoothed unit cost so unseen text degrades to per-character
tokens — never worse than whole-run tokens.

The default lexicon is jieba's open `dict.txt` (349k simplified/
traditional Chinese words with corpus frequencies), which ships in this
image; `IRS_CJK_DICT` overrides it with any "word freq" lines file.
Kana and Hangul runs break on script boundaries (no Japanese/Korean
lexicon is bundled; Korean is space-delimited, and kana-run tokens match
ICU's behavior without cjdict's Japanese extension).

A copy of ``iresearch_tpu/analysis/cjk.py``.
"""

from __future__ import annotations

import math
import os
from typing import Dict, List, Optional, Set, Tuple

_HAN = 0
_HIRA = 1
_KATA = 2
_HANGUL = 3
_OTHER = 4

_MAX_WORD = 16  # longest lexicon word considered by the DP


def _script(cp: int) -> int:
    if 0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF or cp == 0x3007:
        return _HAN
    if 0x3040 <= cp <= 0x309F:
        return _HIRA
    if 0x30A0 <= cp <= 0x30FF or 0x31F0 <= cp <= 0x31FF:
        return _KATA
    if 0xAC00 <= cp <= 0xD7A3 or 0x1100 <= cp <= 0x11FF:
        return _HANGUL
    return _OTHER


def has_cjk(s: str) -> bool:
    return any(_script(ord(c)) != _OTHER for c in s)


class _Lexicon:
    __slots__ = ("logp", "prefixes", "oov_logp", "max_len")

    def __init__(
        self, logp: Dict[str, float], prefixes: Set[str], oov_logp: float
    ) -> None:
        self.logp = logp
        self.prefixes = prefixes
        self.oov_logp = oov_logp
        self.max_len = min(
            _MAX_WORD, max((len(w) for w in logp), default=1)
        )


_LEX: Optional[_Lexicon] = None
_LEX_LOADED = False


def _load_lexicon() -> Optional[_Lexicon]:
    """Parse "word freq [tag]" lines into log-probabilities + a prefix
    set (the early-abort structure for the DP's inner scan)."""
    path = os.environ.get("IRS_CJK_DICT")
    if not path:
        try:
            import jieba  # noqa: F401 — data file only; algorithm is ours

            path = os.path.join(os.path.dirname(jieba.__file__), "dict.txt")
        except ImportError:
            return None
    if not os.path.exists(path):
        return None
    logp: Dict[str, float] = {}
    total = 0
    with open(path, encoding="utf-8") as f:
        for line in f:
            parts = line.split()
            if len(parts) < 2:
                continue
            w = parts[0]
            if len(w) > _MAX_WORD or not has_cjk(w):
                continue
            try:
                freq = int(parts[1])
            except ValueError:
                continue
            logp[w] = float(max(freq, 1))
            total += max(freq, 1)
    if not logp:
        return None
    lt = math.log(total)
    prefixes: Set[str] = set()
    for w in logp:
        logp[w] = math.log(logp[w]) - lt
        for i in range(1, len(w)):
            prefixes.add(w[:i])
    return _Lexicon(logp, prefixes, -lt)


def lexicon() -> Optional[_Lexicon]:
    global _LEX, _LEX_LOADED
    if not _LEX_LOADED:
        _LEX = _load_lexicon()
        _LEX_LOADED = True
    return _LEX


def _segment_han(s: str, lex: _Lexicon) -> List[Tuple[int, int]]:
    """Viterbi max-log-probability split of a pure-Han run into
    [start, end) word spans (ICU CjkBreakEngine's objective)."""
    n = len(s)
    NEG = -1e30
    best = [NEG] * (n + 1)
    back = [0] * (n + 1)
    best[0] = 0.0
    words = lex.logp
    prefixes = lex.prefixes
    maxlen = lex.max_len
    for i in range(n):
        bi = best[i]
        if bi <= NEG:
            continue
        # OOV fallback: one character at the smoothed unit cost
        cand = bi + lex.oov_logp
        if cand > best[i + 1]:
            best[i + 1] = cand
            back[i + 1] = i
        hi = min(i + maxlen, n)
        for j in range(i + 1, hi + 1):
            pre = s[i:j]
            lp = words.get(pre)
            if lp is not None:
                cand = bi + lp
                if cand > best[j]:
                    best[j] = cand
                    back[j] = i
            if j < hi and pre not in prefixes and lp is None:
                break
    spans: List[Tuple[int, int]] = []
    j = n
    while j > 0:
        i = back[j]
        spans.append((i, j))
        j = i
    spans.reverse()
    return spans


def split_word(w: str) -> Optional[List[Tuple[str, int, int]]]:
    """Split one regex "word" that may contain CJK into sub-tokens.

    Returns [(sub, rel_start, rel_end)] with offsets relative to ``w``,
    or None when ``w`` has no CJK at all (caller keeps its fast path).
    Han runs go through the lexicon DP; kana/Hangul runs break only at
    script boundaries; Latin/digit stretches stay whole.
    """
    scripts = [_script(ord(c)) for c in w]
    if all(sc == _OTHER for sc in scripts):
        return None
    out: List[Tuple[str, int, int]] = []
    lex = lexicon()
    i = 0
    n = len(w)
    while i < n:
        sc = scripts[i]
        j = i + 1
        while j < n and scripts[j] == sc:
            j += 1
        if sc == _HAN and lex is not None and j - i > 1:
            for a, b in _segment_han(w[i:j], lex):
                out.append((w[i + a : i + b], i + a, i + b))
        else:
            out.append((w[i:j], i, j))
        i = j
    return out
