"""The one query generator: a traffic mix's file of parameters, read here.

A mix (``traffic/<mix>.json``) names df-rank ``bands`` (``[first, end)``
ranks of the corpus's own doc counts) and ``categories``, each an ``op``
(``term``, ``and``, ``or``) over one term from each of its ``bands``; the
terms of one query are distinct. ``"mix": "fixed"`` is the repo's
``bench.py`` set, built once: ``per_category`` queries of each category in
order, query ``i`` taking term ``i`` of each band (so AndHighMed pairs the
i-th High and Med terms). ``"mix": "random"`` draws each query's category
uniformly and its terms uniformly within their bands, from a stream of the
seed. A query is ``(category, op, term ids)``; the driver spells it as the
program's filter and the reference scores it from the corpus.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Sequence, Tuple

import numpy as np

from benchmark.corpus import stream_seed

OPS = ("term", "and", "or")


class Query(NamedTuple):
    category: str
    op: str
    terms: Tuple[int, ...]


def band_terms(mix: dict, ranked: np.ndarray) -> Dict[str, np.ndarray]:
    """{band: its term ids in rank order}, from the ranked vocabulary."""
    out = {}
    for name, (a, b) in mix["bands"].items():
        if not 0 <= a < b <= len(ranked):
            raise ValueError(f"band {name} [{a}, {b}) outside {len(ranked)} ranked terms")
        out[name] = ranked[a:b]
    return out


def _categories(mix: dict):
    cats = mix["categories"]
    for c in cats:
        if c["op"] not in OPS or not c["bands"] or (c["op"] == "term") != (len(c["bands"]) == 1):
            raise ValueError(f"category {c}: op one of {OPS}, one band for a term")
    return cats


def fixed_mix(mix: dict, bands: Dict[str, np.ndarray]) -> List[Query]:
    """``per_category`` queries of each category, in the file's order."""
    out = []
    for c in _categories(mix):
        for i in range(int(mix["per_category"])):
            terms = tuple(int(bands[b][i % len(bands[b])]) for b in c["bands"])
            if len(set(terms)) != len(terms):
                raise ValueError(f"{c['name']} query {i}: repeated term")
            out.append(Query(c["name"], c["op"], terms))
    return out


class QueryStream:
    """Queries drawn with the random law from stream ``stream`` of
    ``seed``: ``draw(n)`` gives the next ``n``."""

    def __init__(self, mix: dict, bands: Dict[str, np.ndarray], seed: int, stream: str):
        self.cats = _categories(mix)
        for c in self.cats:
            for b in c["bands"]:
                if len(set(bands[b].tolist())) < c["bands"].count(b):
                    raise ValueError(f"band {b} has too few terms for {c['name']}")
        self.bands = bands
        self.rng = np.random.default_rng(stream_seed(seed, f"traffic/{stream}"))

    def one(self) -> Query:
        c = self.cats[int(self.rng.integers(len(self.cats)))]
        terms: List[int] = []
        for b in c["bands"]:
            pool = self.bands[b]
            while True:
                t = int(pool[int(self.rng.integers(len(pool)))])
                if t not in terms:
                    break
            terms.append(t)
        return Query(c["name"], c["op"], tuple(terms))

    def draw(self, n: int) -> List[Query]:
        return [self.one() for _ in range(n)]


def categories_of(queries: Sequence[Query]) -> Dict[str, int]:
    """{category: queries}, for the log."""
    out: Dict[str, int] = {}
    for q in queries:
        out[q.category] = out.get(q.category, 0) + 1
    return out
