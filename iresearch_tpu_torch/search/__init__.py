"""The port's filters, expansion, host oracle and scorers (copies of
``iresearch_tpu/search``), with torch scoring."""

from iresearch_tpu_torch.search.filters import (
    All,
    And,
    ByColumnExistence,
    ByEditDistance,
    ByNested,
    ByPhrase,
    ByPrefix,
    ByRange,
    BySamePosition,
    ByTerm,
    ByTerms,
    ByWildcard,
    Empty,
    Not,
    Or,
)
from iresearch_tpu_torch.search.scorers import BM25, TFIDF, BoostScore, get_scorer

__all__ = [
    "All",
    "And",
    "ByColumnExistence",
    "ByEditDistance",
    "ByNested",
    "ByPhrase",
    "ByPrefix",
    "ByRange",
    "BySamePosition",
    "ByTerm",
    "ByTerms",
    "ByWildcard",
    "Empty",
    "Not",
    "Or",
    "BM25",
    "TFIDF",
    "BoostScore",
    "get_scorer",
]
