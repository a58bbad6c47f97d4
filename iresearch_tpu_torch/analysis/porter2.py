"""Porter2 (snowball English) stemmer, self-contained implementation.

The reference's ``text`` analyzer stems via the vendored snowball C library
(reference: core/analysis/text_token_stream.cpp, external snowball). This is
an independent implementation of the published Porter2 algorithm; tests
verify exact agreement with NLTK's Snowball English stemmer over large
vocabularies.

A copy of ``iresearch_tpu/analysis/porter2.py``.
"""

from __future__ import annotations

VOWELS = frozenset("aeiouy")
DOUBLES = ("bb", "dd", "ff", "gg", "mm", "nn", "pp", "rr", "tt")
LI_ENDINGS = frozenset("cdeghkmnrt")

_EXCEPTIONS = {
    "skis": "ski",
    "skies": "sky",
    "dying": "die",
    "lying": "lie",
    "tying": "tie",
    "idly": "idl",
    "gently": "gentl",
    "ugly": "ugli",
    "early": "earli",
    "only": "onli",
    "singly": "singl",
    "sky": "sky",
    "news": "news",
    "howe": "howe",
    "atlas": "atlas",
    "cosmos": "cosmos",
    "bias": "bias",
    "andes": "andes",
}

_EXCEPTIONS_1A = frozenset(
    ["inning", "outing", "canning", "herring", "earring", "proceed", "exceed", "succeed"]
)

_STEP2 = [
    ("ization", "ize"),
    ("ational", "ate"),
    ("fulness", "ful"),
    ("ousness", "ous"),
    ("iveness", "ive"),
    ("tional", "tion"),
    ("biliti", "ble"),
    ("lessli", "less"),
    ("entli", "ent"),
    ("ation", "ate"),
    ("alism", "al"),
    ("aliti", "al"),
    ("ousli", "ous"),
    ("iviti", "ive"),
    ("fulli", "ful"),
    ("enci", "ence"),
    ("anci", "ance"),
    ("abli", "able"),
    ("izer", "ize"),
    ("ator", "ate"),
    ("alli", "al"),
    ("bli", "ble"),
    ("ogi", None),  # special: -> og if preceded by l
    ("li", None),  # special: delete if valid li-ending precedes
]

_STEP3 = [
    ("ational", "ate"),
    ("tional", "tion"),
    ("alize", "al"),
    ("icate", "ic"),
    ("iciti", "ic"),
    ("ative", None),  # special: delete if in R2
    ("ical", "ic"),
    ("ness", ""),
    ("ful", ""),
]

_STEP4 = [
    "ement",
    "ance",
    "ence",
    "able",
    "ible",
    "ment",
    "ant",
    "ent",
    "ism",
    "ate",
    "iti",
    "ous",
    "ive",
    "ize",
    "ion",  # special: only if preceded by s or t
    "al",
    "er",
    "ic",
]


def _is_vowel(word: str, i: int) -> bool:
    return word[i] in VOWELS and word[i] != "Y" if False else word[i] in "aeiouy"


def _regions(word: str) -> tuple[int, int]:
    """Return (r1, r2) start indices. 'Y' counts as a consonant."""
    n = len(word)
    r1 = n
    for prefix in ("gener", "commun", "arsen"):
        if word.startswith(prefix):
            r1 = len(prefix)
            break
    else:
        for i in range(1, n):
            if word[i] not in VOWELS and word[i - 1] in VOWELS:
                r1 = i + 1
                break
    r2 = n
    for i in range(r1 + 1, n):
        if word[i] not in VOWELS and word[i - 1] in VOWELS:
            r2 = i + 1
            break
    return r1, r2


def _has_vowel(word: str, start: int, end: int) -> bool:
    return any(c in VOWELS for c in word[start:end])


def _ends_short_syllable(word: str) -> bool:
    """Word ends in a short syllable (see spec)."""
    n = len(word)
    if n == 2:
        return word[0] in VOWELS and word[1] not in VOWELS
    if n >= 3:
        c1, v, c2 = word[-3], word[-2], word[-1]
        return (
            v in VOWELS
            and c2 not in VOWELS
            and c2 not in "wxY"
            and c1 not in VOWELS
        )
    return False


def _is_short(word: str, r1: int) -> bool:
    return r1 >= len(word) and _ends_short_syllable(word)


def stem(word: str) -> str:
    """Stem one lowercase word (non-ascii passes through unchanged)."""
    word = word.lower()
    if len(word) <= 2:
        return word
    if word[0] == "'":
        word = word[1:]
    if word in _EXCEPTIONS:
        return _EXCEPTIONS[word]
    if len(word) <= 2:
        return word.rstrip("'") or word

    # mark consonant y as Y
    chars = list(word)
    if chars[0] == "y":
        chars[0] = "Y"
    for i in range(1, len(chars)):
        if chars[i] == "y" and chars[i - 1] in VOWELS:
            chars[i] = "Y"
    word = "".join(chars)

    r1, r2 = _regions(word)

    # step 0
    for suf in ("'s'", "'s", "'"):
        if word.endswith(suf):
            word = word[: -len(suf)]
            break

    # step 1a
    if word.endswith("sses"):
        word = word[:-2]
    elif word.endswith("ied") or word.endswith("ies"):
        word = word[:-2] if len(word) > 4 else word[:-1]
    elif word.endswith("us") or word.endswith("ss"):
        pass
    elif word.endswith("s"):
        if _has_vowel(word, 0, len(word) - 2):
            word = word[:-1]

    if word in _EXCEPTIONS_1A:
        return word.replace("Y", "y")

    # step 1b
    done_1b = False
    for suf, repl_in_r1 in (("eedly", "ee"), ("eed", "ee")):
        if word.endswith(suf):
            if len(word) - len(suf) >= r1:
                word = word[: -len(suf)] + repl_in_r1
            done_1b = True
            break
    if not done_1b:
        for suf in ("ingly", "edly", "ing", "ed"):
            if word.endswith(suf):
                stem_part = word[: -len(suf)]
                if _has_vowel(stem_part, 0, len(stem_part)):
                    word = stem_part
                    if word.endswith(("at", "bl", "iz")):
                        word += "e"
                    elif word.endswith(DOUBLES):
                        word = word[:-1]
                    elif _is_short(word, r1):
                        word += "e"
                break

    # step 1c
    if (
        len(word) > 2
        and word[-1] in "yY"
        and word[-2] not in VOWELS
    ):
        word = word[:-1] + "i"

    # step 2
    for suf, repl in _STEP2:
        if word.endswith(suf):
            if len(word) - len(suf) >= r1:
                if suf == "ogi":
                    if len(word) >= 4 and word[-4] == "l":
                        word = word[:-1]
                elif suf == "li":
                    if len(word) >= 3 and word[-3] in LI_ENDINGS:
                        word = word[:-2]
                else:
                    word = word[: -len(suf)] + repl
            break

    # step 3
    for suf, repl in _STEP3:
        if word.endswith(suf):
            if len(word) - len(suf) >= r1:
                if suf == "ative":
                    if len(word) - len(suf) >= r2:
                        word = word[: -len(suf)]
                else:
                    word = word[: -len(suf)] + repl
            break

    # step 4
    for suf in _STEP4:
        if word.endswith(suf):
            if len(word) - len(suf) >= r2:
                if suf == "ion":
                    if len(word) >= 4 and word[-4] in "st":
                        word = word[:-3]
                else:
                    word = word[: -len(suf)]
            break

    # step 5
    if word.endswith("e"):
        if len(word) - 1 >= r2:
            word = word[:-1]
        elif len(word) - 1 >= r1 and not _ends_short_syllable(word[:-1]):
            word = word[:-1]
    elif word.endswith("ll") and len(word) - 1 >= r2:
        word = word[:-1]

    return word.replace("Y", "y")
