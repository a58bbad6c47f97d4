"""Filter AST (reference: core/search/filter.hpp + per-filter headers).

Filters are immutable descriptions; compilation happens in prepare/planning.
Every reference filter type has a counterpart here:

| reference                  | here               |
|---------------------------|--------------------|
| by_term                   | ByTerm             |
| by_terms                  | ByTerms            |
| by_prefix                 | ByPrefix           |
| by_wildcard               | ByWildcard         |
| by_edit_distance          | ByEditDistance     |
| by_range                  | ByRange            |
| by_granular_range         | ByGranularRange    |
| by_phrase                 | ByPhrase           |
| by_same_position          | BySamePosition     |
| by_ngram_similarity       | ByNgramSimilarity  |
| by_column_existence       | ByColumnExistence  |
| ByNestedFilter            | ByNested           |
| And / Or / Not            | And / Or / Not     |
| all / empty               | All / Empty        |
| proxy_filter              | Proxy              |
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple, Union

DEFAULT_SCORED_TERMS_LIMIT = 1024  # reference: kDefaultScoredTermsLimit


def _b(term: Union[str, bytes]) -> bytes:
    return term.encode("utf-8") if isinstance(term, str) else bytes(term)


@dataclass(frozen=True)
class Filter:
    pass


@dataclass(frozen=True)
class ByTerm(Filter):
    field: str
    term: bytes
    boost: float = 1.0

    def __init__(self, field: str, term: Union[str, bytes], boost: float = 1.0):
        object.__setattr__(self, "field", field)
        object.__setattr__(self, "term", _b(term))
        object.__setattr__(self, "boost", boost)


@dataclass(frozen=True)
class ByTerms(Filter):
    """Explicit term set with per-term boosts; matches min_match of them.

    Reference: terms_filter.hpp:73 (search_options: set of {term, boost},
    min_match).
    """

    field: str
    terms: Tuple[Tuple[bytes, float], ...]
    min_match: int = 1
    boost: float = 1.0

    def __init__(
        self,
        field: str,
        terms: Sequence[Union[str, bytes, Tuple[Union[str, bytes], float]]],
        min_match: int = 1,
        boost: float = 1.0,
    ):
        norm = []
        for t in terms:
            if isinstance(t, tuple):
                norm.append((_b(t[0]), float(t[1])))
            else:
                norm.append((_b(t), 1.0))
        object.__setattr__(self, "field", field)
        object.__setattr__(self, "terms", tuple(norm))
        object.__setattr__(self, "min_match", min_match)
        object.__setattr__(self, "boost", boost)


@dataclass(frozen=True)
class ByPrefix(Filter):
    field: str
    prefix: bytes
    scored_terms_limit: int = DEFAULT_SCORED_TERMS_LIMIT
    boost: float = 1.0

    def __init__(self, field, prefix, scored_terms_limit=DEFAULT_SCORED_TERMS_LIMIT, boost=1.0):
        object.__setattr__(self, "field", field)
        object.__setattr__(self, "prefix", _b(prefix))
        object.__setattr__(self, "scored_terms_limit", scored_terms_limit)
        object.__setattr__(self, "boost", boost)


@dataclass(frozen=True)
class ByWildcard(Filter):
    """``%`` = any sequence, ``_`` = one character, ``\\`` escapes.

    Reference: wildcard_filter.hpp:56, wildcard_utils.hpp:30.
    """

    field: str
    pattern: bytes
    scored_terms_limit: int = DEFAULT_SCORED_TERMS_LIMIT
    boost: float = 1.0

    def __init__(self, field, pattern, scored_terms_limit=DEFAULT_SCORED_TERMS_LIMIT, boost=1.0):
        object.__setattr__(self, "field", field)
        object.__setattr__(self, "pattern", _b(pattern))
        object.__setattr__(self, "scored_terms_limit", scored_terms_limit)
        object.__setattr__(self, "boost", boost)


@dataclass(frozen=True)
class ByEditDistance(Filter):
    """Fuzzy match by (Damerau-)Levenshtein distance <= max_distance.

    Reference: levenshtein_filter.hpp:34-82 (distance 0..4, transpositions,
    fixed prefix); matched-term boost = 1 - d/min(|term|,|target|).
    """

    field: str
    term: bytes
    max_distance: int = 1
    with_transpositions: bool = True
    prefix: bytes = b""
    scored_terms_limit: int = DEFAULT_SCORED_TERMS_LIMIT
    boost: float = 1.0

    def __init__(
        self,
        field,
        term,
        max_distance=1,
        with_transpositions=True,
        prefix=b"",
        scored_terms_limit=DEFAULT_SCORED_TERMS_LIMIT,
        boost=1.0,
    ):
        if not 0 <= max_distance <= 4:
            raise ValueError("max_distance must be in [0, 4]")
        object.__setattr__(self, "field", field)
        object.__setattr__(self, "term", _b(term))
        object.__setattr__(self, "max_distance", max_distance)
        object.__setattr__(self, "with_transpositions", with_transpositions)
        object.__setattr__(self, "prefix", _b(prefix))
        object.__setattr__(self, "scored_terms_limit", scored_terms_limit)
        object.__setattr__(self, "boost", boost)


@dataclass(frozen=True)
class ByRange(Filter):
    """Term range [low, high] with inclusive/exclusive bounds.

    Reference: range_filter.hpp (BoundType min/max inclusive/exclusive).
    ``None`` bound = unbounded.
    """

    field: str
    low: Optional[bytes] = None
    high: Optional[bytes] = None
    include_low: bool = True
    include_high: bool = True
    scored_terms_limit: int = DEFAULT_SCORED_TERMS_LIMIT
    boost: float = 1.0

    def __init__(
        self,
        field,
        low=None,
        high=None,
        include_low=True,
        include_high=True,
        scored_terms_limit=DEFAULT_SCORED_TERMS_LIMIT,
        boost=1.0,
    ):
        object.__setattr__(self, "field", field)
        object.__setattr__(self, "low", None if low is None else _b(low))
        object.__setattr__(self, "high", None if high is None else _b(high))
        object.__setattr__(self, "include_low", include_low)
        object.__setattr__(self, "include_high", include_high)
        object.__setattr__(self, "scored_terms_limit", scored_terms_limit)
        object.__setattr__(self, "boost", boost)


@dataclass(frozen=True)
class ByGranularRange(Filter):
    """Numeric range over multi-precision numeric terms.

    Reference: granular_range_filter.hpp:40-71 + numeric_token_stream.
    """

    field: str
    low: Optional[float] = None
    high: Optional[float] = None
    include_low: bool = True
    include_high: bool = True
    scored_terms_limit: int = DEFAULT_SCORED_TERMS_LIMIT
    boost: float = 1.0


class PhrasePart:
    """Base for variadic phrase position specs (reference: by_phrase
    'variadic' parts, phrase_filter.hpp:41-139)."""


@dataclass(frozen=True)
class PhraseTerm(PhrasePart):
    term: bytes

    def __init__(self, term):
        object.__setattr__(self, "term", _b(term))


@dataclass(frozen=True)
class PhrasePrefix(PhrasePart):
    prefix: bytes
    scored_terms_limit: int = DEFAULT_SCORED_TERMS_LIMIT

    def __init__(self, prefix, scored_terms_limit=DEFAULT_SCORED_TERMS_LIMIT):
        object.__setattr__(self, "prefix", _b(prefix))
        object.__setattr__(self, "scored_terms_limit", scored_terms_limit)


@dataclass(frozen=True)
class PhraseWildcard(PhrasePart):
    pattern: bytes

    def __init__(self, pattern):
        object.__setattr__(self, "pattern", _b(pattern))


@dataclass(frozen=True)
class PhraseSet(PhrasePart):
    terms: Tuple[bytes, ...]

    def __init__(self, terms):
        object.__setattr__(self, "terms", tuple(_b(t) for t in terms))


@dataclass(frozen=True)
class PhraseFuzzy(PhrasePart):
    term: bytes
    max_distance: int = 1
    with_transpositions: bool = True

    def __init__(self, term, max_distance=1, with_transpositions=True):
        object.__setattr__(self, "term", _b(term))
        object.__setattr__(self, "max_distance", max_distance)
        object.__setattr__(self, "with_transpositions", with_transpositions)


@dataclass(frozen=True)
class ByPhrase(Filter):
    """Positional phrase; parts are (offset, part) with offsets allowing
    gaps (reference: by_phrase push_back with offs)."""

    field: str
    parts: Tuple[Tuple[int, PhrasePart], ...]
    boost: float = 1.0

    def __init__(self, field, parts, boost: float = 1.0):
        norm: List[Tuple[int, PhrasePart]] = []
        offset = 0
        for p in parts:
            if isinstance(p, tuple):
                offset += int(p[0])
                part = p[1]
            else:
                part = p
            if isinstance(part, (str, bytes)):
                part = PhraseTerm(part)
            norm.append((offset, part))
            offset += 1
        object.__setattr__(self, "field", field)
        object.__setattr__(self, "parts", tuple(norm))
        object.__setattr__(self, "boost", boost)


@dataclass(frozen=True)
class BySamePosition(Filter):
    """All (field, term) pairs co-occurring at one position.

    Reference: same_position_filter.hpp.
    """

    terms: Tuple[Tuple[str, bytes], ...]
    boost: float = 1.0

    def __init__(self, terms, boost: float = 1.0):
        object.__setattr__(
            self, "terms", tuple((f, _b(t)) for f, t in terms)
        )
        object.__setattr__(self, "boost", boost)


@dataclass(frozen=True)
class ByNgramSimilarity(Filter):
    """Match docs whose longest common ngram sequence ratio >= threshold.

    Reference: ngram_similarity_filter.hpp.
    """

    field: str
    ngrams: Tuple[bytes, ...]
    threshold: float = 0.5
    boost: float = 1.0

    def __init__(self, field, ngrams, threshold=0.5, boost=1.0):
        if not 0.0 < threshold <= 1.0:
            raise ValueError("threshold must be in (0, 1]")
        object.__setattr__(self, "field", field)
        object.__setattr__(self, "ngrams", tuple(_b(t) for t in ngrams))
        object.__setattr__(self, "threshold", threshold)
        object.__setattr__(self, "boost", boost)


@dataclass(frozen=True)
class ByColumnExistence(Filter):
    """Docs carrying a column; ``prefix_match`` treats ``column`` as a
    name prefix (reference: by_column_existence ColumnAcceptor,
    column_existence_filter.hpp:32-38)."""

    column: str
    prefix_match: bool = False
    boost: float = 1.0


@dataclass(frozen=True)
class ByNested(Filter):
    """Parent/child block join (reference: nested_filter.hpp:35-53).

    ``parent`` selects parent docs; ``child`` matches child docs; a parent
    matches when the number of matching children is within [min, max]
    (``None`` max = unbounded). Children of parent p are the docs in
    (prev_parent, p) — the reference's block layout convention.
    """

    parent: "Filter"
    child: "Filter"
    min_match: int = 1
    max_match: Optional[int] = None
    boost: float = 1.0


@dataclass(frozen=True)
class And(Filter):
    """Conjunction; ``merge`` picks the child-score merger
    (reference: ScoreMergeType kSum/kMax/kMin/kNoop, scorer.hpp:224-235)."""

    filters: Tuple[Filter, ...]
    boost: float = 1.0
    merge: str = "sum"  # sum | max | min | noop

    def __init__(self, *filters: Filter, boost: float = 1.0, merge: str = "sum"):
        if len(filters) == 1 and isinstance(filters[0], (list, tuple)):
            filters = tuple(filters[0])
        assert merge in ("sum", "max", "min", "noop")
        object.__setattr__(self, "filters", tuple(filters))
        object.__setattr__(self, "boost", boost)
        object.__setattr__(self, "merge", merge)


@dataclass(frozen=True)
class Or(Filter):
    """Disjunction with ``min_match`` (reference: boolean_filter.hpp:34-117).

    ``min_match=0`` matches everything (like the reference's adjusted
    min_match semantics with match-all).
    """

    filters: Tuple[Filter, ...]
    min_match: int = 1
    boost: float = 1.0
    merge: str = "sum"  # sum | max | min | noop (ScoreMergeType)

    def __init__(
        self,
        *filters: Filter,
        min_match: int = 1,
        boost: float = 1.0,
        merge: str = "sum",
    ):
        if len(filters) == 1 and isinstance(filters[0], (list, tuple)):
            filters = tuple(filters[0])
        assert merge in ("sum", "max", "min", "noop")
        object.__setattr__(self, "filters", tuple(filters))
        object.__setattr__(self, "min_match", min_match)
        object.__setattr__(self, "boost", boost)
        object.__setattr__(self, "merge", merge)


@dataclass(frozen=True)
class Not(Filter):
    filter: Filter
    boost: float = 1.0


@dataclass(frozen=True)
class All(Filter):
    boost: float = 1.0


@dataclass(frozen=True)
class Empty(Filter):
    pass


@dataclass(frozen=True)
class Proxy(Filter):
    """Caches the wrapped filter's per-segment match set across executions
    (reference: proxy_filter.hpp:41-48). State lives in the prepared query.
    """

    filter: Filter
    boost: float = 1.0
