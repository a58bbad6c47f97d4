"""Segment-sharded query execution (``iresearch_tpu/parallel/sharded.py``).

The host half is a copy of the JAX package's: ``prepare_many`` plans every
query on every segment through ``HostQuery`` and ``PlanCompiler`` over the
uniform dense layout (``parallel/dense_stack.py``), makes one tier uniform
across segments per query (``dslice`` runs as ``direct``, ``join`` is
re-pinned to ``dense`` or ``sort``, ``gridmix`` only with a uniform group
structure), unions the dense spans and groups the queries by signature.
Phrases take the ``"keys"`` form (``exec/phrase.py:PhraseKeysSpec``) unless
their structure differs across segments or ``nd_pad << caplog`` reaches
2^31; then the host evaluates them as aux leaves.

The device half is PyTorch's own idiom where the JAX package has a
``Mesh``, ``shard_map`` and ``jit``. The mesh (``make_mesh``) is this
process's local devices, one shard each (the same device may repeat),
times the processes of a ``torch.distributed`` group: ``D = world x
len(devices)`` shards, as ``mesh.devices.size`` is in JAX. Segment ``s``
lies on global shard ``s // per_shard``; this process holds shards
``[rank * len(devices), (rank + 1) * len(devices))``, each on its device,
and per signature group and shard calls the single-segment runners of
``exec/batch.py`` (fold with aux, WAND, the candidate tiers) on the
shard's segments' resident pools, at the GLOBAL ``nd_pad`` (the power of
two of the largest segment) as every shard runs in the JAX package. Each
segment's top-k, its doc base added, concatenates along the candidate
axis; the join (``_join``) copies the shards' candidates onto the mesh's
first device (peer to peer between cards that allow it), concatenates
them in shard order, gathers every process's candidates with one
``all_gather_into_tensor`` where there is a group, and one exact (score
desc, doc asc) re-rank gives the global top-k.

Per searcher, field and segment the ``norms`` (clamped to 1, padded with
1) and ``alive`` (padded with False) are held at ``nd_pad`` on the
segment's shard's device, and the uniform dense pools are uploaded there
on first use. A prepared batch packs each signature group's host-made
arrays of each shard into one buffer and one upload to the shard's device
(``exec/batch.py:_pack_args``). Where the join runs depends on the group's
backend (``Mesh.join_in_graph``):

* **NCCL** (one process per card, every shard of a process on that
  card): ``run`` replays one CUDA graph per signature group holding the
  whole group body, every local shard's runners, the doc-base shift and
  concat, the NCCL ``all_gather`` and the re-rank, the counterpart of the
  JAX package's one ``shard_map`` program per group
  (``_sharded_topk_batch``). The collective is in the graph, so a replay
  makes no call into ``torch.distributed``; every rank replays every
  group in the same order, a rank without segments a body that gives
  ``-inf`` candidates.
* **gloo, or no group** (ranks sharing a card or on the CPU): ``run``
  replays one graph per group and shard (with a single shard the re-rank
  in it too), every shard's issued before any candidate is copied, so
  that distinct cards run at once; the join follows the replays, since
  ``gloo`` stages CUDA tensors on the host, which a graph cannot hold.

A group's graphs are one entry of ``exec/batch.py``'s "sharded" LRU, so a
fresh ``prepare_many`` of the same structure on the same searcher replays
them; ``run(fused=False)`` runs the same bodies eagerly (the debug path).
"""

from __future__ import annotations

import math
from collections import namedtuple
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from iresearch_tpu_torch.device import require_cuda
from iresearch_tpu_torch.exec.batch import (
    _materialize,
    _pack_args,
    _run_candidates,
    _run_fold,
    _run_fused_group,
    _run_wand,
    _template_key,
    warming_up,
)
from iresearch_tpu_torch.exec.executor import (
    KERNELS,
    PLAIN,
    check_port_objects,
    entry_device,
)
from iresearch_tpu_torch.exec.phrase import phrase_rows
from iresearch_tpu_torch.exec.plan import PlanCompiler
from iresearch_tpu_torch.formats.bitpack import BITS, words_per_block
from iresearch_tpu_torch.index.segment import _i32, device_state
from iresearch_tpu_torch.search import filters as F
from iresearch_tpu_torch.search.host_eval import HostQuery
from iresearch_tpu_torch.search.scorers import BM25, Scorer, f32

_IMAX32 = 2**31 - 1

class Mesh(namedtuple("Mesh", "group rank world devices")):
    """The shards a searcher spans: this process's ``devices`` (one shard
    each, in order) in every process of ``group`` (``rank`` of ``world``;
    None with one process). ``join_in_graph`` (an attribute, which follows
    from ``group``): the group is NCCL's, so the all_gather and the
    re-rank run inside each group's graph."""

    def __new__(cls, group, rank, world, devices, join_in_graph=False):
        self = super().__new__(cls, group, rank, world, devices)
        self.join_in_graph = join_in_graph
        return self

    @property
    def size(self) -> int:
        """Shards in the whole mesh (the JAX ``mesh.devices.size``)."""
        return self.world * len(self.devices)


def make_mesh(devices=None, group=None) -> Mesh:
    """The mesh a searcher shards over (the counterpart of the JAX
    package's ``make_mesh(devices)``): ``devices``, this process's devices
    with one shard each (the same device may repeat; the CPU only where
    named), every visible card when None (JAX's ``jax.devices()``; raises
    where there is none), times the processes of ``group`` when given, else
    of the default group where ``torch.distributed`` is initialized with
    more than one process, else of this process alone. A group of one
    process passed as ``group`` keeps its collective, as JAX's all_gather
    runs whatever the size of its axis.

    On an NCCL group the join runs inside each group's graph; that needs
    every device of the process to be one card that no other rank holds
    (NCCL puts one rank on a card), else this raises. It never falls back
    to another backend."""
    import torch.distributed as dist

    if devices is None:
        require_cuda()
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = tuple(entry_device(d) for d in devices)
    if not devices:
        raise ValueError("a mesh needs at least one device")
    if group is None:
        if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() == 1:
            return Mesh(None, 0, 1, devices)
        group = dist.group.WORLD
    rank, world = dist.get_rank(group), dist.get_world_size(group)
    nccl = dist.get_backend(group) == "nccl"
    if nccl:
        _own_card(devices, group, world)
    return Mesh(group, rank, world, devices, nccl)


def _own_card(devices, group, world: int) -> None:
    """Raise unless ``devices`` are one card that no other rank of the
    NCCL ``group`` holds (each rank's card told apart by its UUID, gathered
    over the group: a collective that also makes the group's communicator
    exist before any graph captures one)."""
    import torch.distributed as dist

    card = devices[0]
    if card.type != "cuda" or any(d != card for d in devices):
        raise ValueError(
            f"an NCCL mesh needs all of the process's shards on one card of its own, got "
            f"{[str(d) for d in devices]}; use a gloo group for the CPU or several cards")
    uuid = str(torch.cuda.get_device_properties(card).uuid)
    uuids = [None] * world
    with torch.cuda.device(card):
        dist.all_gather_object(uuids, uuid, group=group)
    if uuids.count(uuid) > 1:
        raise ValueError(
            f"an NCCL mesh puts one rank on a card: {card} ({uuid}) is held by ranks "
            f"{[r for r, u in enumerate(uuids) if u == uuid]}; use a gloo group for "
            f"ranks that share a card")


def _all_gather(vals, docs, mesh: Mesh):
    """(vals, docs) [q, world * w] of every process's candidates ``vals``
    f32 and ``docs`` i32 [q, w], rank by rank along the candidate axis (the
    JAX package's ``moveaxis(all_gather(x), 0, 1).reshape(q, -1)``): the
    pair in one ``all_gather_into_tensor`` into one preallocated [world *
    2, q, w] buffer, with no wait on the host. In a capture's warm-up
    (``exec/batch.py:warming_up``) the buffer is zeroed instead, so that a
    miss issues the collectives a hit does."""
    import torch.distributed as dist

    q, w = vals.shape
    mine = torch.stack([vals.view(torch.int32), docs])
    got = torch.empty((mesh.world * 2, q, w), dtype=torch.int32, device=mine.device)
    if warming_up():
        got.zero_()
    else:
        dist.all_gather_into_tensor(got, mine, group=mesh.group)
    both = got.view(mesh.world, 2, q, w).permute(1, 2, 0, 3).reshape(2, q, mesh.world * w)
    return both[0].view(torch.float32), both[1]


def _pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


class _KeysRows:
    """``phrase_keys`` of ``_run_fold`` in the keys form: per phrase-keys
    aux leaf (match bool [Q, nd], score f32 [Q, nd]) of a chunk's (keys
    per part [Q, NK], w [Q]) (the JAX package's ``sharded.py:777-806``).
    ``consts`` holds per leaf (norms f32 [nd], avgdl, caplog); each avgdl
    is put on the norms' device here, at prepare, since a graph's capture
    cannot upload it. Equal and hashed by what it computes with, the
    norms' addresses and the scalars, not by identity: a fused group's key
    holds it (and with it the tensors its graph reads), and a fresh
    prepare makes a new one."""

    def __init__(self, consts, scorer: Scorer, nd: int) -> None:
        self.scorer, self.nd = scorer, nd
        self.consts = tuple(
            (n, torch.tensor(a, dtype=torch.float32, device=n.device), c) for n, a, c in consts)
        self._sig = (
            tuple((n.data_ptr(), tuple(n.shape), n.dtype, n.device, a, c) for n, a, c in consts),
            scorer, nd,
        )

    def __eq__(self, other) -> bool:
        return isinstance(other, _KeysRows) and self._sig == other._sig

    def __hash__(self) -> int:
        return hash(self._sig)

    def __call__(self, pr):
        return tuple(
            phrase_rows(keys, w, norms, avgdl, scorer=self.scorer, shift=caplog, nd=self.nd)
            for (keys, w), (norms, avgdl, caplog) in zip(pr, self.consts)
        )


class ShardedSearcher:
    """Shards a reader's segments over a mesh of devices and processes
    and runs exact top-k.

    ``devices``: this process's devices, one shard each (the same device
    may repeat); ``device`` alone is a mesh of that one device; with
    neither, every visible card (raises where there is none). The tests
    pass ``"cpu"``. ``group``: the processes (``make_mesh``). Results lie
    on ``device``, the mesh's first device. ``segments`` are the port's
    own readers."""

    def __init__(self, segments: Sequence, group=None, *, device=None,
                 devices=None) -> None:
        self.segments = list(segments)
        check_port_objects(self.segments)
        if device is not None and devices is not None:
            raise ValueError("pass device or devices, not both")
        self.mesh = make_mesh([device] if device is not None else devices, group)
        self.device = self.mesh.devices[0]
        self.D = self.mesh.size
        # the shards' candidates meet in ``_join`` (several shards, or an
        # NCCL group's collective, whatever its size); else the one shard
        # re-ranks its own
        self.joined = self.D > 1 or self.mesh.join_in_graph
        S = max(1, math.ceil(len(self.segments) / self.D) * self.D)
        self.S = S
        self.per_shard = S // self.D
        self.nd_pad = max(
            [_pow2(max(1, sr.num_docs)) for sr in self.segments] or [1]
        )
        self._doc_base = np.zeros(S, np.int32)
        base = 0
        for i, sr in enumerate(self.segments):
            self._doc_base[i] = base
            base += sr.num_docs
        self.total_docs = base
        # this process's shards: (global shard, device, its segments), the
        # segments of global shard g being [g * per_shard, (g + 1) *
        # per_shard); padding segments (past the real ones) hold no doc and
        # are left out, so a shard may hold none
        first = self.mesh.rank * len(self.mesh.devices)
        self.shards = []
        for j, dev in enumerate(self.mesh.devices):
            lo = (first + j) * self.per_shard
            segs = [si for si in range(lo, lo + self.per_shard) if si < len(self.segments)]
            self.shards.append((first + j, dev, segs))
        self.local = [si for _g, _d, segs in self.shards for si in segs]
        self._seg_device = {si: dev for _g, dev, segs in self.shards for si in segs}
        self._alive = {si: self._alive_of(si) for si in self.local}
        self._norms: Dict[Tuple[str, int], torch.Tensor] = {}
        self._zero_pools: Dict[tuple, tuple] = {}
        self._dense_layouts: Dict[str, object] = {}
        self._dense_pool_cache: Dict[Tuple[str, int, int], torch.Tensor] = {}

    # --- residency at the global nd_pad, on each segment's shard's device -

    def _up(self, arr, dtype, si: int) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr, dtype)).to(self._seg_device[si])

    def _alive_of(self, si: int) -> torch.Tensor:
        sr = self.segments[si]
        alive = np.zeros(self.nd_pad, np.bool_)
        alive[: sr.num_docs] = sr.alive
        return self._up(alive, np.bool_, si)

    def _norms_of(self, fname: str, si: int) -> torch.Tensor:
        """Segment ``si``'s norms of ``fname``: max(norms, 1), padded with
        1 to ``nd_pad`` (the JAX package's ``sharded.py:162-166``)."""
        key = (fname, si)
        t = self._norms.get(key)
        if t is None:
            norms = np.ones(self.nd_pad, np.float32)
            fp = self.segments[si].field(fname)
            if fp is not None:
                norms[: len(fp.norms)] = np.maximum(fp.norms, 1)
            t = self._norms[key] = self._up(norms, np.float32, si)
        return t

    def _group_pool(self, si: int, fname: str, dcls: int, fcls: int, ncls: int):
        """(doc_words, freq_words, nrm_words, base, norms) of one row group
        on segment ``si``, on its shard's device: the segment's resident
        pools (``device_state``, once per segment and card), or zero pools
        of the group's widths, one set per card, where it lacks the field
        or its norm pools (every row of its groups is then the all-zero
        sentinel row 0)."""
        norms = self._norms_of(fname, si)
        sr = self.segments[si]
        dev = self._seg_device[si]
        if sr.field(fname) is not None:
            dfield = device_state(sr, dev).field(fname)
            if ncls < 0 or dfield.nrm_words is not None:
                nrm = dfield.nrm_words[ncls] if ncls >= 0 else dfield.freq_words[fcls]
                return (dfield.doc_words[dcls], dfield.freq_words[fcls], nrm,
                        dfield.base[dcls], norms)
        key = (dev, dcls, fcls, ncls)
        z = self._zero_pools.get(key)
        if z is None:
            def zeros(cls):
                return torch.zeros((1, words_per_block(BITS[cls])), dtype=torch.int32,
                                   device=dev)

            fw = zeros(fcls)
            z = self._zero_pools[key] = (
                zeros(dcls), fw, fw if ncls < 0 else zeros(ncls),
                torch.zeros(1, dtype=torch.int32, device=dev))
        return z + (norms,)

    @property
    def device_bytes(self) -> int:
        """Bytes this searcher holds on the device beside the segments' own
        residency: alive, norms and the uniform dense pools. They are not
        counted in the resource manager's ``"device"`` category: the JAX
        package counts nothing of its searcher either, only the segments'
        residency (``index/segment.py``)."""
        ts = (list(self._alive.values()) + list(self._norms.values())
              + list(self._dense_pool_cache.values()))
        return sum(t.nbytes for t in ts)

    # --- uniform cross-shard dense layout --------------------------------

    def _dense_layout(self, fname: str):
        lay = self._dense_layouts.get(fname)
        if lay is None:
            from iresearch_tpu_torch.parallel.dense_stack import UniformDenseLayout

            lay = UniformDenseLayout(self.segments, fname)
            self._dense_layouts[fname] = lay
        return lay

    def _dense_pool(self, fname: str, cls: int, si: int) -> torch.Tensor:
        key = (fname, cls, si)
        cached = self._dense_pool_cache.get(key)
        if cached is None:
            pool = self._dense_layout(fname).pools_np[cls][si]
            cached = self._up(_i32(pool), np.int32, si)
            self._dense_pool_cache[key] = cached
        return cached

    def _wrapped_segments(self):
        from iresearch_tpu_torch.parallel.dense_stack import wrap_segments

        class _LazyLayouts(dict):
            def __init__(inner, outer):
                super().__init__()
                inner._outer = outer

            def get(inner, fname, default=None):
                lay = dict.get(inner, fname)
                if lay is None:
                    lay = inner._outer._dense_layout(fname)
                    inner[fname] = lay
                return lay

        return wrap_segments(self.segments, _LazyLayouts(self))

    # --- query ----------------------------------------------------------

    def prepare_many(
        self,
        filters: Sequence[F.Filter],
        scorer: Optional[Scorer] = None,
        wand: bool = False,
        wand_sample: int = 16,
        k_max: int = 128,
    ) -> "PreparedShardedBatch":
        """Plan, group and upload a batch of queries once
        (``ShardedSearcher.prepare_many``): queries are grouped by plan
        signature, and each group runs per segment as one stacked call of
        the tier's runner. ``k_max``: the largest top-k this prepare may
        serve (it bounds the scored-only multiterm plans; ``run(k)``
        rejects k beyond it)."""
        scorer = scorer or BM25()
        check_port_objects(self.segments, scorer)
        for flt in filters:
            if not isinstance(flt, F.Filter):
                raise TypeError(f"filter {flt!r} is not an iresearch_tpu_torch Filter")
        S = len(self.segments)
        wsegs = self._wrapped_segments()
        per_query = []  # (plans, mode, use_wand, uordered, phspecs, caplog)
        self_kmax = None
        for flt in filters:
            prepared = HostQuery(flt, wsegs, scorer)
            compiler = PlanCompiler(prepared, scorer)

            def compile_all(device_phrase="keys", **kw):
                plans = [
                    compiler.compile(
                        flt, s, wand=wand, device_phrase=device_phrase, **kw
                    )
                    for s in range(S)
                ]
                # scored-only plans are exact only for k <= kmax; honor
                # the caller's k_max by recompiling exhaustively
                for s, p in enumerate(plans):
                    if 0 < p.scored_only_kmax < k_max:
                        plans[s] = compiler.compile(
                            flt, s, wand=wand, device_phrase=device_phrase,
                            scored_only=False, **kw,
                        )
                return plans

            dp = "keys"
            plans = compile_all(device_phrase=dp, dense=True)
            # device-phrase keys (exec/phrase.py:PhraseKeysSpec) need a
            # shard-invariant structure: same aux slots, same part
            # counts, and i32 key headroom. Otherwise host-eval the aux.
            ph_struct = {
                tuple(
                    (ai, len(spec.part_keys64))
                    for ai, spec in p.device_aux
                )
                for p in plans
            }
            caplog = 0
            if len(ph_struct) != 1:
                dp = False
                plans = compile_all(device_phrase=dp, dense=True)
            elif next(iter(ph_struct)):
                max_pos = max(
                    (
                        spec.max_pos
                        for p in plans
                        for _ai, spec in p.device_aux
                    ),
                    default=0,
                )
                caplog = max(1, int(max_pos).bit_length())
                if self.nd_pad << caplog >= 2**31:
                    dp = False
                    caplog = 0
                    plans = compile_all(device_phrase=dp, dense=True)
            for p in plans:
                if p.scored_only_kmax > 0:
                    self_kmax = min(
                        self_kmax or p.scored_only_kmax, p.scored_only_kmax
                    )
            active = [p for p in plans if p.groups or p.dense_spans]
            # dslice (contiguous-slice decode) shares the direct tier's
            # rowset structure; the sharded executor runs it as "direct"
            _norm = lambda m: "direct" if m == "dslice" else m  # noqa: E731
            modes = {_norm(p.exec_mode) for p in active}
            mode = None
            if len(modes) == 1:
                m = next(iter(modes))
                if m == "join":
                    # join splits groups per span (segment-dependent key
                    # structure) — not stackable across shards; the repin
                    # below picks dense (grid spans present) or sort
                    mode = None
                elif m == "gridmix":
                    sigs = {
                        (
                            len(p.groups),
                            tuple(int(g.leaf[0]) for g in p.groups),
                        )
                        for p in active
                    }
                    if len(sigs) == 1:
                        mode = "gridmix"
                else:
                    mode = m
            if mode is None:
                # divergent tiers: re-pin. Dense-fold is universal; sort
                # needs a covering aux-free tree.
                if not active:
                    mode = "dense"
                    plans = compile_all(device_phrase=dp, modes=False, dense=True)
                elif any(_norm(p.exec_mode) == "dense" for p in active) or any(
                    p.dense_spans for p in plans
                ):
                    mode = "dense"
                    plans = compile_all(device_phrase=dp, modes=False, dense=True)
                else:
                    mode = "sort"
                    plans = compile_all(device_phrase=dp, force_mode="sort", dense=False)
                    if any(
                        p.exec_mode != "sort" for p in plans if p.groups
                    ):
                        mode = "dense"  # force_mode fell back (non-covering)
                        plans = compile_all(device_phrase=dp, modes=False, dense=True)
            use_wand = (
                wand
                and any(p.groups or p.dense_spans for p in plans)
                and all(g.ub is not None for p in plans for g in p.groups)
                and all(
                    d.ub is not None for p in plans for d in p.dense_spans
                )
                # wand plumbing exists for the fold tiers only (plan.py
                # disables ub emission for join/gridmix anyway)
                and mode in ("dense", "direct", "sort")
            )
            # union of dense spans across shards, aligned by the
            # shard-invariant (leaf, field, class, ndrows, start) identity
            # (starts are term-keyed and uniform — dense_stack.py); a
            # shard lacking the term reads its zero rows at the same
            # start, an exact no-op
            uspans: Dict[tuple, dict] = {}
            for si, p in enumerate(plans):
                for d in p.dense_spans:
                    key = (d.leaf, d.field_name, d.cls, d.ndrows, d.start)
                    ent = uspans.get(key)
                    if ent is None:
                        ent = uspans[key] = {
                            "w": {}, "avgdl": d.avgdl, "ub": {},
                        }
                    # w is per SHARD: multiterm sampling scores only the
                    # sampled (segment, term) visits (w=0 elsewhere)
                    ent["w"][si] = d.w
                    if d.ub is not None:
                        ent["ub"][si] = d.ub
            uordered = [
                (k[0], k[1], k[2], k[3], k[4], v["w"], v["avgdl"], v["ub"])
                for k, v in sorted(uspans.items())
            ]
            # phrase-keys aux: per aux slot, the per-shard specs (same
            # structure across shards — checked above)
            phspecs = []
            if dp == "keys" and plans[0].device_aux:
                for pi, (ai, _spec0) in enumerate(plans[0].device_aux):
                    phspecs.append(
                        (ai, [p.device_aux[pi][1] for p in plans])
                    )
            per_query.append((plans, mode, use_wand, uordered, phspecs, caplog))
        self._last_kmax = self_kmax  # None = exhaustive for any k

        groups_by_sig: Dict[tuple, List[int]] = {}
        for qi, (plans, mode, use_wand, uordered, phspecs, caplog) in enumerate(
            per_query
        ):
            p0 = plans[0]
            qkeys = tuple(sorted({
                (g.field_name, g.dcls, g.fcls, g.ncls)
                for p in plans
                for g in p.groups
            }))
            # dense structure: per-span static geometry, start excluded
            # (dynamic, stacked along Q)
            dkeys = tuple((u[0], u[1], u[2], u[3]) for u in uordered)
            A = max(
                [0] + [
                    0 if p.aux_pairs is None else len(p.aux_pairs)
                    for p in plans
                ]
            )
            rmax = {}
            for p in plans:
                for g in p.groups:
                    kk = (g.field_name, g.dcls, g.fcls, g.ncls)
                    rmax[kk] = max(rmax.get(kk, 8), len(g.rows_d))
            # phrase static structure: (aux_idx, nparts, key buckets,
            # caplog, score-field) per aux slot
            pkeys_sig = tuple(
                (
                    ai,
                    len(specs[0].part_keys64),
                    tuple(
                        _pow2(
                            max(
                                [8]
                                + [len(sp.part_keys64[m]) for sp in specs]
                            )
                        )
                        for m in range(len(specs[0].part_keys64))
                    ),
                    caplog,
                    specs[0].field_name,
                )
                for ai, specs in phspecs
            )
            sig = (
                p0.tree, p0.num_leaves, mode, use_wand, qkeys, A,
                tuple(_pow2(rmax[kk]) for kk in qkeys),
                dkeys,
                pkeys_sig,
            )
            groups_by_sig.setdefault(sig, []).append(qi)

        groups, calls = [], []
        for sig, qis in groups_by_sig.items():
            gi = len(groups)
            group, gcalls = self._group_calls(
                sig, qis, per_query, scorer, wand_sample, k_max
            )
            groups.append(group)
            calls += [c + (gi,) for c in gcalls]
        return PreparedShardedBatch(self, groups, calls, kmax=self_kmax)

    def _group_calls(self, sig, qis, per_query, scorer, wand_sample, k_max):
        """((query_indices, mode, use_wand, cap), [(tier, query_indices,
        runner, args, kwargs, segment)]) of one signature group: the
        [S, Q, ...] host arrays of the JAX package's ``sharded.py:437-606``,
        then per local segment its slices (numpy arrays, which
        ``PreparedShardedBatch`` packs into one upload per group) beside
        the segment's resident tensors, and the tier's runner."""
        tree, num_leaves, mode, use_wand, qkeys, A, Rs, dkeys, pkeys_sig = sig
        # θ pruning is useless when the sampled phase already decodes
        # every row (same rule as exec/batch.py); dense spans keep it
        # (rows per span = ndrows >> sample)
        use_wand = use_wand and (
            max(Rs, default=0) > wand_sample or bool(dkeys)
        )
        S = self.S
        Q = len(qis)
        G = len(qkeys)
        avgdl = np.ones(max(G, 1), np.float32)
        gleaf = [0] * max(G, 1)
        cols = [("rows_d", np.int32), ("rows_f", np.int32), ("rows_n", np.int32),
                ("weight", np.float32), ("leaf", np.int32)]
        if use_wand:
            cols += [("ub", np.float32), ("other", np.float32)]
        rowsets_np = []
        for gi, key in enumerate(qkeys):
            R = Rs[gi]
            # padding rows: the sentinel row 0, ub -inf (sorts last)
            arrs = [np.full((S, Q, R), -np.inf if name == "ub" else 0, dt)
                    for name, dt in cols]
            for j, qi in enumerate(qis):
                for i, p in enumerate(per_query[qi][0]):
                    for gi2, g in enumerate(p.groups):
                        if (g.field_name, g.dcls, g.fcls, g.ncls) != key:
                            continue
                        for arr, (name, _dt) in zip(arrs, cols):
                            src = getattr(g, name)
                            arr[i, j, : len(src)] = src
                        avgdl[gi] = p.group_avgdl[gi2]
                        gleaf[gi] = int(g.leaf[0])
            rowsets_np.append(arrs)
        leaf_min_b = np.stack([per_query[qi][0][0].leaf_min_match for qi in qis])
        # dense-grid spans from the uniform layout: starts/weights stack
        # along Q (uniform across shards); weights and WAND bounds per shard
        dense_np, dense_static = [], []
        for di, (dleaf, fname, cls, ndrows) in enumerate(dkeys):
            starts = np.zeros(Q, np.int32)
            ws = np.zeros((S, Q), np.float32)
            davg = 1.0
            ub = np.full((S, Q, ndrows), -np.inf, np.float32) if use_wand else None
            other = np.zeros((S, Q), np.float32) if use_wand else None
            for j, qi in enumerate(qis):
                u = per_query[qi][3][di]
                starts[j] = u[4]
                for si, w_s in u[5].items():
                    ws[si, j] = w_s
                davg = u[6]
                if use_wand:
                    for si, ub_s in u[7].items():
                        ub[si, j, : len(ub_s)] = ub_s
                    for si, p in enumerate(per_query[qi][0]):
                        for d in p.dense_spans:
                            if (d.leaf, d.field_name, d.cls, d.ndrows,
                                    d.start) == (dleaf, fname, cls, ndrows, u[4]):
                                other[si, j] = d.other
            dense_np.append((fname, cls, starts, ws, davg, ub, other))
            dense_static.append((BITS[cls], dleaf, ndrows, True))
        # phrase-keys aux: per aux slot, per part i32 keys [S, Q, NK]
        # (IMAX-padded), per-shard weights [S, Q], the score field's avgdl
        phrase_np = []
        for pi, (ai, nparts, buckets, caplog_a, fld) in enumerate(pkeys_sig):
            keys_parts = []
            for m in range(nparts):
                karr = np.full((S, Q, buckets[m]), _IMAX32, np.int32)
                for j, qi in enumerate(qis):
                    for si, sp in enumerate(per_query[qi][4][pi][1]):
                        k64 = sp.part_keys64[m]
                        if len(k64):
                            k32 = ((k64 >> 32) << caplog_a) | (k64 & 0xFFFFFFFF)
                            karr[si, j, : len(k64)] = k32.astype(np.int32)
                keys_parts.append(karr)
            w_arr = np.zeros((S, Q), np.float32)
            pavg = 1.0
            for j, qi in enumerate(qis):
                for si, sp in enumerate(per_query[qi][4][pi][1]):
                    w_arr[si, j] = sp.weight
                    pavg = sp.avgdl
            phrase_np.append((ai, keys_parts, w_arr, pavg, caplog_a, fld))
        lanes = (sum(Rs) if mode != "dense" else 0) * 128
        cap = lanes if mode in ("direct", "sort", "join") and not dkeys else self.nd_pad
        kk = min(k_max, self.nd_pad, cap)
        if mode != "dense":
            tier = mode
        elif use_wand:
            tier = "wand"
        else:
            tier = "aux" if A else "fold"

        def up(a, dtype):
            # packed per group by ``PreparedShardedBatch``: one upload
            return np.ascontiguousarray(a, dtype)

        avgdl_t = up(avgdl, np.float32)
        leaf_min_t = up(leaf_min_b, np.int32)
        davg_t = [up(np.float32(d[4]), np.float32) for d in dense_np]
        starts_t = [up(d[2], np.int32) for d in dense_np]
        gbits = tuple(
            (BITS[dc], BITS[fc], BITS[nc] if nc >= 0 else -1)
            for _f, dc, fc, nc in qkeys
        )
        common = dict(
            tree=tree, gbits=gbits, scorer=scorer, num_leaves=num_leaves,
            k=kk, nd=self.nd_pad, dense_static=tuple(dense_static),
        )
        dev_slots = [ph[0] for ph in phrase_np]
        calls = []
        for si in self.local:
            pools = tuple(self._group_pool(si, *key) for key in qkeys)
            rowsets = tuple(
                tuple(up(arr[si], dt) for arr, (_n, dt) in zip(arrs, cols))
                for arrs in rowsets_np
            )
            dense_shared = tuple(
                (self._dense_pool(fname, cls, si), self._norms_of(fname, si), davg_t[di])
                for di, (fname, cls, *_r) in enumerate(dense_np)
            )
            dense_dyn = []
            for di, (_f, _c, _st, ws, _a, ub, other) in enumerate(dense_np):
                dd = (starts_t[di], up(ws[si], np.float32))
                if use_wand:
                    dd += (up(ub[si], np.float32), up(other[si], np.float32))
                dense_dyn.append(dd)
            dense_dyn = tuple(dense_dyn)
            alive = self._alive[si]
            if mode != "dense":
                args = (pools, rowsets, avgdl_t, leaf_min_t, alive, None,
                        dense_shared, dense_dyn)
                kwargs = dict(
                    common, mode=mode, driver_gi=-1,
                    group_leaf=tuple(gleaf[:G]), wand=use_wand,
                    sample=wand_sample, wand_mode="exact",
                )
                calls.append((tier, qis, _run_candidates, args, kwargs, si))
                continue
            if use_wand:
                args = (pools, rowsets, avgdl_t, leaf_min_t, alive,
                        dense_shared, dense_dyn)
                kwargs = dict(common, sample=wand_sample, wand_mode="exact")
                calls.append((tier, qis, _run_wand, args, kwargs, si))
                continue
            # host aux leaves: sparse per-segment arrays, densified by the
            # runner; the phrase-keys leaves overwrite their slots
            aux_sp, aux_rows = [], []
            for a in range(A):
                if a in dev_slots:
                    aux_rows.append((True, dev_slots.index(a)))
                    continue
                aux_rows.append((False, len(aux_sp)))
                pairs = []
                for qi in qis:
                    ap = per_query[qi][0][si].aux_pairs
                    pairs.append(ap[a] if ap is not None and a < len(ap)
                                 else (np.zeros(0, np.int32), np.zeros(0, np.float32)))
                Mp = _pow2(max(8, max(len(d) for d, _v in pairs)))
                docs = np.full((Q, Mp), _IMAX32, np.int32)
                vals = np.zeros((Q, Mp), np.float32)
                for j, (d, v) in enumerate(pairs):
                    docs[j, : len(d)] = d
                    vals[j, : len(v)] = v
                aux_sp.append((docs, vals))
            phrase, keys_fn = None, None
            if phrase_np:
                # per leaf (keys per part [Q, NK], w [Q]), in the packed
                # buffer with the rest
                phrase = tuple(
                    (tuple(up(karr[si], np.int32) for karr in parts), up(w_arr[si], np.float32))
                    for _ai, parts, w_arr, _pavg, _cl, _fld in phrase_np
                )
                keys_fn = _KeysRows(
                    tuple(
                        (self._norms_of(fld, si), f32(pavg), caplog_a)
                        for _ai, _p, _w, pavg, caplog_a, fld in phrase_np
                    ),
                    scorer, self.nd_pad,
                )
            args = (pools, rowsets, avgdl_t, leaf_min_t, tuple(aux_sp), alive,
                    dense_shared, dense_dyn, phrase)
            kwargs = dict(common, aux_rows=tuple(aux_rows), phrase_keys=keys_fn)
            calls.append((tier, qis, _run_fold, args, kwargs, si))
        return (qis, mode, use_wand, cap), calls

    def _shard_candidates(self, runs, q: int, kk: int, dev, kern=KERNELS):
        """[vals, docs] of one shard from its segments' ``runs`` ([((vals,
        local docs), segment)]): the docs made global, the top-k lists
        concatenated along the candidate axis to ``per_shard * kk`` (the
        padding segments given no candidate), and where nothing joins the
        shards (``joined``) the final re-rank (``kern.topk``)."""
        vals = [v for (v, _d), _si in runs]
        docs = [d + int(self._doc_base[si]) for (_v, d), si in runs]
        pad = self.per_shard - len(runs)
        if pad:
            vals.append(torch.full((q, kk * pad), float("-inf"), dtype=torch.float32,
                                   device=dev))
            docs.append(torch.zeros((q, kk * pad), dtype=torch.int32, device=dev))
        vals, docs = torch.cat(vals, dim=1), torch.cat(docs, dim=1)
        return list((vals, docs) if self.joined else kern.topk(vals, docs, kk))

    def _join(self, outs, q: int, kk: int, kern=KERNELS):
        """Global [vals [q, kk], docs [q, kk]] of this process's shards'
        candidates ``outs`` ([vals, docs] per shard, None for a shard
        without segments, which gives ``-inf`` candidates): each copied onto
        the mesh's first device (ordered after the current streams of both
        cards; peer to peer where the cards allow it), concatenated in shard
        order, gathered across the group's processes (``_all_gather``) and
        re-ranked by (score desc, doc asc) with ``kern.topk`` (the JAX
        package's ``sharded.py:848-863``). Makes no host wait, so that a graph can
        hold it on an NCCL mesh."""
        dev = self.device
        w = self.per_shard * kk
        vals = torch.cat([
            torch.full((q, w), float("-inf"), dtype=torch.float32, device=dev) if o is None
            else o[0].to(dev, non_blocking=True) for o in outs], dim=1)
        docs = torch.cat([
            torch.zeros((q, w), dtype=torch.int32, device=dev) if o is None
            else o[1].to(dev, non_blocking=True) for o in outs], dim=1)
        if self.mesh.world > 1 or self.mesh.join_in_graph:
            vals, docs = _all_gather(vals, docs, self.mesh)
        return list(kern.topk(vals, docs, kk))

    def search(
        self, flt: F.Filter, scorer: Optional[Scorer] = None, k: int = 10
    ) -> List[Tuple[int, float]]:
        vals, docs = self.search_arrays(flt, scorer, k)
        out = []
        for v, d in zip(vals.cpu().numpy(), docs.cpu().numpy()):
            if math.isinf(v) and v < 0:
                continue
            out.append((int(d), float(v)))
        return out

    def search_arrays(self, flt: F.Filter, scorer: Optional[Scorer], k: int):
        return self.prepare(flt, scorer).run(k)

    def prepare(
        self,
        flt: F.Filter,
        scorer: Optional[Scorer] = None,
        wand: bool = False,
        k_max: int = 128,
    ) -> "PreparedShardedQuery":
        """Plan and upload one query once; the returned query's ``run(k)``
        only launches work. The same machinery as ``prepare_many`` with
        Q = 1; ``k_max`` bounds scored-only multiterm plans."""
        return PreparedShardedQuery(
            self.prepare_many([flt], scorer, wand=wand, k_max=k_max)
        )


class PreparedShardedBatch:
    """A sharded batch resident on the mesh: each signature group's
    host-made arrays of each shard in one packed upload to the shard's
    device; ``run`` replays per group one CUDA graph of the whole group
    body on an NCCL mesh, else one per group and shard."""

    def __init__(self, searcher: ShardedSearcher, groups, calls, kmax=None) -> None:
        self.searcher = searcher
        # per signature group: (query_indices, mode, use_wand, cap), cap
        # the candidate lanes that bound its k
        self.groups = groups
        # per group, per local shard: ([(runner, template, kwargs,
        # segment)], buffer, long-lived tensors, the args over the buffer),
        # None for a shard without segments; the groups' fused keys by k
        self._packs, self._keys = [], {}
        # per (group, local segment): (tier, query_indices, runner, args
        # over the group's shard's buffer, kwargs, segment, group index)
        self._calls = []
        for gi in range(len(groups)):
            packs = []
            for _g, dev, segs in searcher.shards:
                mine = [c for c in calls if c[6] == gi and c[5] in segs]
                if not mine:
                    packs.append(None)
                    continue
                templates, buf, dev_args = _pack_args([c[3] for c in mine], dev)
                args = [_materialize(tp, buf, dev_args) for tp in templates]
                packs.append((
                    tuple((c[2], tp, c[4], c[5]) for c, tp in zip(mine, templates)),
                    buf, dev_args, args,
                ))
                self._calls += [c[:3] + (a,) + c[4:] for c, a in zip(mine, args)]
            self._packs.append(packs)
        self.num_queries = sum(len(g[0]) for g in groups)
        self._kmax = kmax  # None = exhaustive for any k

    @property
    def calls(self):
        """[(tier, query_indices, runner, args, kwargs)], one per (group,
        local segment) in run order, at the prepared ``k_max``, for
        checking a kernel at the real shapes (as ``PreparedBatch.calls``)."""
        return [c[:5] for c in self._calls]

    def _live(self, gi: int):
        """The local shards of group ``gi`` that hold segments."""
        return [j for j, p in enumerate(self._packs[gi]) if p is not None]

    def fused_key(self, gi: int, kk: int) -> tuple:
        """Group ``gi``'s key in ``exec/batch.py``'s "sharded" LRU at top-
        ``kk``: per local shard with segments its global index and device,
        its runners, templates and kwargs, its long-lived tensors'
        addresses and its segments' doc bases; the padding, the mesh's size
        and world, the group's queries, ``kk``, and where the join runs:
        the NCCL group whose collective the graph holds, else None."""
        key = self._keys.get((gi, kk))
        if key is None:
            s = self.searcher
            parts = []
            for (g, dev, _segs), pack in zip(s.shards, self._packs[gi]):
                if pack is None:
                    continue
                tps, buf, dev_args, _args = pack
                parts.append((
                    g, dev,
                    _template_key(tuple((fn, tp, dict(kw, k=kk)) for fn, tp, kw, _si in tps),
                                  dev_args, buf),
                    tuple(int(s._doc_base[si]) for *_r, si in tps),
                ))
            key = self._keys[(gi, kk)] = (
                "sharded", tuple(parts), s.per_shard, s.D, s.mesh.world,
                len(self.groups[gi][0]), kk, s.mesh.group if s.mesh.join_in_graph else None)
        return key

    def _shard_body(self, gi: int, j: int, kk: int, q: int, kern=KERNELS):
        """``body((buf,))`` -> [vals, docs] of group ``gi`` on local shard
        ``j``: its segments' runners on the kernel set ``kern`` over
        ``buf`` (``body(None)``: over the batch's own buffer, its args
        made once), then ``_shard_candidates``."""
        tps, _buf, dev_args, own = self._packs[gi][j]
        s = self.searcher
        dev = s.shards[j][1]

        def body(bufs):
            args = own if bufs is None else [_materialize(tp, bufs[0], dev_args)
                                             for _fn, tp, _kw, _si in tps]
            runs = [(fn(kern, *a, **dict(kw, k=kk)), si)
                    for (fn, _tp, kw, si), a in zip(tps, args)]
            return s._shard_candidates(runs, q, kk, dev, kern)

        return body

    def _group_body(self, gi: int, kk: int, q: int, kern=KERNELS):
        """``body(bufs)`` -> [vals, docs] [q, kk], group ``gi``'s global
        top-``kk``: every local shard's body (``bufs``: one buffer per shard
        with segments, in shard order; None: the batch's own), then the
        join (``ShardedSearcher._join``), or with nothing to join the one
        shard's re-ranked candidates. What an NCCL mesh captures per group
        and runs eagerly."""
        s = self.searcher
        live = self._live(gi)
        bodies = [self._shard_body(gi, j, kk, q, kern) for j in live]

        def body(bufs):
            outs = [None] * len(self._packs[gi])
            for i, (j, b) in enumerate(zip(live, bodies)):
                outs[j] = b(None if bufs is None else (bufs[i],))
            return s._join(outs, q, kk, kern) if s.joined else outs[0]

        return body

    def run(self, k: int, plain: bool = False, fused: bool = True):
        """Per-query (scores f32 [k'], global docs i32 [k']) tensors on the
        mesh's first device, k' = min(k, nd_pad, the group's lanes); -inf
        scores are non-matches. ``fused=True`` (default) replays, per
        signature group, captured the first time a group of its structure
        runs on this searcher: on an NCCL mesh one graph of the whole group
        body (``_group_body``: the runners, the all_gather and the re-rank),
        with no call into ``torch.distributed``; else one graph per shard,
        every shard's issued before the candidates are joined.
        ``fused=False`` runs the same bodies eagerly (the debug path), on a
        gloo mesh every group's shard work issued before the joins;
        ``plain=True`` runs them on the kernels' plain versions. Every
        group runs in every process, in the same order, whatever its
        shards hold."""
        if self._kmax is not None and k > self._kmax:
            raise ValueError(
                f"prepared for top-k <= {self._kmax} (scored-only multiterm"
                f" plans); re-prepare with k_max >= {k}"
            )
        s = self.searcher
        kern = PLAIN if plain else KERNELS
        # every group's work on every shard is issued first, so that no
        # card waits for another's group before its next one; a gloo
        # mesh's joins follow
        issued = []
        for gi, (qis, _mode, _wand, cap) in enumerate(self.groups):
            kk = min(k, s.nd_pad, cap)
            q = len(qis)
            live = self._live(gi)
            outs = [None] * len(self._packs[gi])
            got = None  # None: the shards' ``outs`` are joined below
            if s.mesh.join_in_graph and (plain or not fused):
                got = self._group_body(gi, kk, q, kern)(None)
            elif s.mesh.join_in_graph:
                (got,) = _run_fused_group("sharded", self.fused_key(gi, kk), [(
                    s.device, tuple(self._packs[gi][j][1] for j in live),
                    self._group_body(gi, kk, q))])
            elif plain or not fused:
                for j in live:
                    outs[j] = self._shard_body(gi, j, kk, q, kern)(None)
            elif live:
                parts = [(s.shards[j][1], (self._packs[gi][j][1],), self._shard_body(gi, j, kk, q))
                         for j in live]
                for j, o in zip(live, _run_fused_group("sharded", self.fused_key(gi, kk), parts)):
                    outs[j] = o
            issued.append((qis, kk, outs, got))
        out = [None] * self.num_queries
        for qis, kk, outs, got in issued:
            if got is None:
                got = s._join(outs, len(qis), kk, kern) if s.joined else outs[0]
            vals, docs = got
            for j, qi in enumerate(qis):
                out[qi] = (vals[j], docs[j])
        return out

    def top_k(self, k: int) -> List[List[Tuple[int, float]]]:
        out = []
        for vals, docs in self.run(k):
            hits = []
            for v, d in zip(vals.cpu().numpy(), docs.cpu().numpy()):
                if math.isinf(v) and v < 0:
                    continue
                hits.append((int(d), float(v)))
            out.append(hits[:k])
        return out


class PreparedShardedQuery:
    """A prepared sharded query: ``run(k)`` only launches work. A Q = 1
    view of ``PreparedShardedBatch``."""

    def __init__(self, batch: PreparedShardedBatch) -> None:
        self._batch = batch
        self.searcher = batch.searcher

    def run(self, k: int, plain: bool = False, fused: bool = True):
        """(scores f32 [k'], global docs i32 [k']) on the device."""
        return self._batch.run(k, plain, fused)[0]

    def top_k(self, k: int) -> List[Tuple[int, float]]:
        return self._batch.top_k(k)[0]
