"""The comparison that decides ``correct``.

Each answer the program served (a query's top-k as float32 scores and
global docs, ``-inf`` past its matches) is judged against the float64
reference of its configuration:

* ``hits_off``: answers whose finite entries are not a prefix of exactly
  min(k, matches) entries;
* ``wrong_docs``: served entries whose doc does not match the query or
  repeats within its answer;
* ``rank_gap``: the widest gap by which a served doc's reference score
  lies below the reference's score at the same rank, relative to the
  latter (0 when the right docs come in the right order; a swap inside a
  near-tie reads as small as the tie);
* ``score_err``: the widest relative gap between a served score and the
  reference's score of the served doc.

The limits were set from readings on the card (``PERF.md`` §2): the
program's largest over a dozen seeds and more, and the control's (the
reference in bfloat16 put in the program's place, ``benchmark/control.py``)
smallest. Counts are exact: their limit is 0.
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

import numpy as np
import torch

from benchmark.traffic import Query

LIMITS: Dict[str, float] = {
    "hits_off": 0,
    "wrong_docs": 0,
    "rank_gap": 1e-4,
    "score_err": 1e-4,
}


def judge(answers: Iterable[Tuple[Query, np.ndarray, np.ndarray]], ref, k: int) -> Dict[str, float]:
    """The compared numbers over ``answers`` ((query, vals [k], docs [k]))
    and how many answers were judged."""
    out = {"answers": 0, "hits_off": 0, "wrong_docs": 0, "rank_gap": 0.0, "score_err": 0.0}
    cache: Dict[Query, object] = {}
    for q, vals, docs in answers:
        out["answers"] += 1
        ans = cache.get(q)
        if ans is None:
            ans = cache[q] = ref.evaluate(q)
        vals = np.asarray(vals, np.float64)
        fin = np.isfinite(vals)
        want = min(k, ans.n)
        nfin = int(fin.sum())
        if nfin != want or not fin[:nfin].all():
            out["hits_off"] += 1
        served = np.asarray(docs)[:nfin][fin[:nfin]].astype(np.int64)
        sv = vals[:nfin][fin[:nfin]]
        if not len(served):
            continue
        dev = ans.docs.device
        found, sc = ref.score_of(ans, torch.from_numpy(served).to(dev))
        found = found.cpu().numpy()
        _, uniq = np.unique(served, return_index=True)
        first = np.zeros(len(served), bool)
        first[uniq] = True
        ok = found & first
        out["wrong_docs"] += int((~ok).sum())
        if not ok.any():
            continue
        got = sc.double().cpu().numpy()
        top = ans.top(want)[1].double().cpu().numpy()
        r = np.flatnonzero(ok)
        r = r[r < len(top)]
        if len(r):
            gap = (top[r] - got[r]) / top[r]
            out["rank_gap"] = max(out["rank_gap"], float(gap.max()), 0.0)
        r = np.flatnonzero(ok)
        err = np.abs(sv[r] - got[r]) / got[r]
        out["score_err"] = max(out["score_err"], float(err.max()))
    return out


def passed(numbers: Dict[str, float]) -> bool:
    return all(numbers[name] <= limit for name, limit in LIMITS.items())


def lines(numbers: Dict[str, float]):
    """Each compared number beside its limit, one line each."""
    return [f"check {name} {numbers[name]!r} limit {limit!r}" for name, limit in LIMITS.items()]
