"""Device-side global top-k merge across segments (``exec/segmerge.py``).

A multi-segment index (the shape any real index has after tiered
consolidation — reference: ConsolidateTier, core/utils/index_utils.hpp:32-84,
and the per-segment execute loop in utils/index-search.cpp:714-780) answers
a query by executing per segment and merging the per-segment top-k. The
reference merges in the caller's min-heap on the CPU; here the merge is
enqueued on the device behind the segments' groups, so nothing crosses to
the host until the caller fetches the final [Q, k]:

* each segment's :class:`PreparedBatch` yields per signature group a
  ``[Qg, k']`` (vals, docs) pair — groups differ per segment (row buckets
  depend on that segment's dfs), so the outputs concatenate and permute
  back to query order with a per-segment inverse permutation (static per
  prepared batch);
* the ``S * k`` global candidates of each query merge by (score desc,
  global doc asc): one select by one int64 key per (score, doc)
  (``ops/topk.py:topk_docs``, K4 on the card), where the JAX package
  sorts on two keys with ``lax.sort``. Ties across segments so come out
  in the engine-wide (score, doc) order.

Global doc ids are ``segment_base + local_doc`` with bases the prefix sum
of segment doc counts (must stay < 2^31: docs are int32 in both packages).

``run()`` is one pass: every segment's groups and the merge in one CUDA
graph, cached in ``exec/batch.py:_FUSED_CACHE`` under ``("segfused",
(each segment's batch key), k)`` and fed from the batches' packed buffers
(``fused=False``, the debug path, runs each segment's groups and then the
merge eagerly). Without a counterpart here: the JAX package's
cross-segment padding of ``prepare_all`` (``_joint_pad``). It pads every
segment's groups to the same shapes so that equal-shape segments share one
compiled program; a graph bakes in each segment's own pool addresses, so
no two segments could share one, and the padding would only widen the
groups.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from iresearch_tpu_torch.exec.batch import (
    KERNELS,
    PLAIN,
    _kept,
    _materialize,
    _pack_args,
    _run_fused,
    entry_device,
)
from iresearch_tpu_torch.utils.timer import span

_NEG_INF = float("-inf")


def _merge_flat(gvs, gds, gather, row_base, *, q: int, k: int, kern=KERNELS):
    """The merge on flat lists of per-group ``[Qg, k']`` tensors, every
    segment's groups in order. ``gather`` int64 [q * S] names, query by
    query and segment by segment, the row of their concatenation;
    ``row_base`` int32 [S * q] is each concatenated row's segment base;
    the select is ``kern.topk``."""

    def padk(a, fill):
        if a.shape[1] == k:
            return a
        return torch.nn.functional.pad(a, (0, k - a.shape[1]), value=fill)

    v = torch.cat([padk(g, _NEG_INF) for g in gvs])
    d = torch.cat([padk(g, 0) for g in gds]) + row_base[:, None]
    return kern.topk(v[gather].reshape(q, -1), d[gather].reshape(q, -1), k)


def _flat_index(perms: np.ndarray, bases: np.ndarray):
    """(gather int64 [Q * S], row_base int32 [S * Q]) of ``_merge_flat``
    from the per-segment permutations [S, Q] and doc bases [S]."""
    s, q = perms.shape
    gather = (perms.astype(np.int64) + q * np.arange(s, dtype=np.int64)[:, None]).T
    return np.ascontiguousarray(gather).reshape(-1), np.repeat(bases.astype(np.int32), q)


def merge_body(gvs, gds, perms, bases, *, k: int):
    """Assemble and merge (``exec/segmerge.py:_merge_body``).

    gvs/gds: tuple over segments of tuples of per-group [Qg, k'] tensors
    (vals f32 / local docs i32); perms [S, Q] maps query order to
    concat-of-groups order; bases [S] i32 per-segment doc offsets.
    Prepare clamps each group's k' to min(k, nd, lanes), so a tiny
    segment (a normal pre-consolidation shape) yields k' < k — every
    group pads to the requested global ``k`` with (-inf, 0) sentinels
    (padded entries rank last and are non-finite, the same not-a-match
    convention the per-segment top-k uses).
    Returns global (vals [Q, k] f32, docs [Q, k] i32)."""
    dev = gvs[0][0].device
    gather, row_base = _flat_index(
        np.asarray(perms.cpu() if isinstance(perms, torch.Tensor) else perms),
        np.asarray(bases.cpu() if isinstance(bases, torch.Tensor) else bases),
    )
    return _merge_flat(
        [g for v in gvs for g in v], [g for d in gds for g in d],
        torch.from_numpy(gather).to(dev), torch.from_numpy(row_base).to(dev),
        q=perms.shape[1], k=k,
    )


def perm_of(prep) -> np.ndarray:
    """Inverse permutation of a PreparedBatch's group order ([Q] i32)."""
    qorder = np.concatenate([np.asarray(c[1], np.int64) for c in prep.calls])
    return np.argsort(qorder).astype(np.int32)


class MergedBatch:
    """Prepared multi-segment batch: run() -> global (vals, docs) [Q, k].

    Built from one :class:`PreparedBatch` per segment (same queries, same
    k). ``run()`` replays one CUDA graph of every segment's groups and the
    merge; the result stays on the device until fetched. ``device`` is
    where the prepared batches live (the card when None)."""

    def __init__(
        self, preps: Sequence, num_docs: Sequence[int], k: int = None,
        *, device=None,
    ) -> None:
        if len(preps) != len(num_docs):
            raise ValueError("one PreparedBatch per segment required")
        # global k: the cross-segment merge width; None resolves at run()
        # to the max per-group width over all segments (every group's k'
        # is the requested k clamped by segment size, so the max IS the
        # request whenever any segment is big enough to satisfy it).
        self.k = None if k is None else int(k)
        total = int(np.sum(np.asarray(num_docs, np.int64)))
        if total >= 2**31:
            raise ValueError(
                f"global doc ids need {total} < 2^31 (docs are int32); "
                "split the index across shards instead"
            )
        with span("merge.init"):
            self.preps = list(preps)
            bases = np.zeros(len(preps), np.int32)
            np.cumsum(np.asarray(num_docs[:-1], np.int64), out=bases[1:])
            gather, row_base = _flat_index(
                np.stack([perm_of(p) for p in self.preps]), bases
            )
            self.num_queries = self.preps[0].num_queries
            (tp,), self._buf, _ = _pack_args([(gather, row_base)], entry_device(device))
            self._index = tp
            self._gather, self._row_base = _materialize(tp, self._buf, ())

    def _k(self) -> int:
        """The merge width: ``k``, or when None the widest group's k
        (``exec/segmerge.py:MergedBatch.run``)."""
        if self.k is not None:
            return self.k
        return max(kw.get("k", 0) for p in self.preps for _fn, _tp, kw in p._templates)

    def fused_key(self) -> tuple:
        """This pass's key in ``exec/batch.py:_FUSED_CACHE``."""
        return ("segfused", tuple(p._key for p in self.preps), self._k())

    def run(self, fused: bool = True, plain: bool = False):
        """Global (vals [Q, k], docs [Q, k]) on the device, fresh tensors.

        ``fused=True`` (default): one CUDA graph of every segment's groups
        and the merge, replayed with one launch and cached by the segments'
        batch keys, so a fresh ``prepare_all`` of the same structure replays
        it. ``fused=False``: each segment's groups and the merge enqueued
        eagerly, with no synchronise (the debug path). ``plain=True`` runs
        the kernels' plain PyTorch versions eagerly. Span ``batch.run``
        (the merge has none of its own: on the fused path it runs inside
        the replayed graph)."""
        with span("batch.run"):
            k = self._k()
            if plain or not fused:
                return self.merge(
                    [g for p in self.preps for g, _qis in p.run_grouped(False, plain)],
                    k, PLAIN if plain else KERNELS,
                )
            bodies = [p._body(KERNELS) for p in self.preps]
            index, q = self._index, self.num_queries

            def body(bufs):
                outs = [o for b, buf in zip(bodies, bufs) for o in b((buf,))]
                gather, row_base = _materialize(index, bufs[-1], ())
                return list(_merge_flat(outs[0::2], outs[1::2], gather, row_base, q=q, k=k))

            kept = tuple(x for p in self.preps for x in _kept(p._dev_args))
            vals, docs = _run_fused(
                "batch", self.fused_key(), tuple(p._buf for p in self.preps) + (self._buf,),
                body, kept,
            )
            return vals, docs

    def merge(self, outs, k: int = None, kern=KERNELS) -> Tuple[torch.Tensor, torch.Tensor]:
        """The merge alone, on ``outs``: the ``(vals, docs)`` pair of every
        group of every segment, in ``preps`` order, on the kernel set
        ``kern``; ``k`` defaults to ``self.k`` or the widest group."""
        if k is None:
            k = self.k if self.k is not None else max(v.shape[1] for v, _d in outs)
        return _merge_flat(
            [v for v, _d in outs], [d for _v, d in outs],
            self._gather, self._row_base, q=self.num_queries, k=k, kern=kern,
        )

    def search(self, k: int) -> List[List[Tuple[int, float]]]:
        """Fetched global top-k as [(global_doc, score), ...] per query
        (finite-score entries only) — same convention as
        QueryBatch.search."""
        vals, docs = self.run()
        vals = vals.cpu().numpy()
        docs = docs.cpu().numpy()
        out: List[List[Tuple[int, float]]] = []
        for qi in range(vals.shape[0]):
            fin = np.isfinite(vals[qi])
            out.append(
                [
                    (int(d), float(v))
                    for v, d in zip(vals[qi][fin][:k], docs[qi][fin][:k])
                ]
            )
        return out
