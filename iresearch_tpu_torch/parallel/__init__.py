"""Scale-out: segment sharding (``iresearch_tpu/parallel``).

The JAX package places segments along a 1-D ``jax.sharding.Mesh`` and runs
each query under ``shard_map``. Here a searcher's segments are split over
the processes of a ``torch.distributed`` group (``make_mesh`` gives the
``(group, rank, world)`` it uses; one process holds every segment when no
group of more than one process exists, as on one card). Each process runs
its own segments through the single-segment runners and the candidates
meet in an ``all_gather`` and one exact (score, doc) re-rank
(``sharded.py``).
"""

from iresearch_tpu_torch.parallel.sharded import ShardedSearcher, make_mesh

__all__ = ["ShardedSearcher", "make_mesh"]
