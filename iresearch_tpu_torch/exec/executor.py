"""Per-query preparation for the torch executor (``exec/executor.py``).

``TorchQuery`` is the counterpart of ``DeviceQuery`` without any device
inputs: prepare goes through the JAX package's jax-free ``HostQuery``,
``PlanCompiler``, ``get_plan`` and ``plan_for_k``, so sampled terms, idf
stats and tier choice are identical to the reference by construction.
Plans are shared with the JAX package through the prepared-plan cache:
the port never mutates one, and keys what it stores in ``plan.cache``
under its own names.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

from iresearch_tpu.search import filters as F
from iresearch_tpu.search.host_eval import HostQuery
from iresearch_tpu.search.scorers import BM25, Scorer
from iresearch_tpu_torch._host import plan as _plan
from iresearch_tpu_torch._host import plancache as _plancache


def scan_shape(plan):
    """Fused-scan eligibility of a plan: None, "or" (any-hit, spans sum
    into one leaf), "and" (all-hit, one span per leaf), or int mm >= 2
    (a min_match disjunction, one span per leaf). A copy of
    ``exec/executor.py:scan_shape``, which cannot be imported without jax.
    """
    if (
        plan.exec_mode != "dense"
        or plan.groups
        or not plan.dense_spans
        or plan.aux_pairs is not None
        or plan.device_aux
    ):
        return None
    L = plan.num_leaves
    if any(int(m) > 1 for m in plan.leaf_min_match[:L]):
        return None
    if plan.tree == ("leaf", 0) and L == 1:
        return "or"
    t = plan.tree
    if (
        t[0] in ("and", "or")
        and not t[2]
        and t[4 if t[0] == "or" else 3] == "sum"
        and all(c[0] == "leaf" for c in t[1])
        and sorted(c[1] for c in t[1]) == list(range(L))
        and [ds.leaf for ds in plan.dense_spans] == list(range(L))
    ):
        if t[0] == "and":
            return "and"
        if int(t[3]) >= 2:
            return int(t[3])
    return None


class TorchQuery:
    """A prepared query for the torch executor (plans only, no uploads).

    Plans are compiled with ``device_phrase=False``, as ``QueryBatch``
    compiles them in the JAX package (phrases are host aux leaves)."""

    def __init__(
        self,
        flt: F.Filter,
        segments: Sequence,
        scorer: Optional[Scorer] = None,
        wand: bool = False,
    ) -> None:
        self.flt = flt
        self.scorer = scorer or BM25()
        self.wand = wand
        self.prepared = HostQuery(flt, list(segments), self.scorer)
        self.compiler = _plan.PlanCompiler(self.prepared, self.scorer)
        self._plans: Dict[int, _plan.SegmentPlan] = {}
        self._full_plans: Dict[int, _plan.SegmentPlan] = {}

    def plan(self, seg_idx: int):
        p = self._plans.get(seg_idx)
        if p is None:
            p = _plancache.get_plan(
                self.compiler,
                self.flt,
                seg_idx,
                wand=self.wand,
                device_phrase=False,
                scorer=self.scorer,
            )
            self._plans[seg_idx] = p
        return p

    def plan_for_k(self, seg_idx: int, k: int):
        """Plan valid for a top-k of ``k`` (scored-only multiterm plans
        fall back to the full plan beyond ``scored_only_kmax``)."""
        p = self.plan(seg_idx)
        if 0 < p.scored_only_kmax < k:
            p = self._full_plans.get(seg_idx)
            if p is None:
                p = self.compiler.compile(
                    self.flt,
                    seg_idx,
                    wand=self.wand,
                    device_phrase=False,
                    scored_only=False,
                )
                self._full_plans[seg_idx] = p
        return p
