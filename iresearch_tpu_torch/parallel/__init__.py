"""Scale-out: segment sharding (``iresearch_tpu/parallel``).

The JAX package places segments along a 1-D ``jax.sharding.Mesh`` and runs
each query under ``shard_map``. Here the mesh (``make_mesh``) is a
process's local devices, one shard each, times the processes of a
``torch.distributed`` group; a searcher's segments are split over its
shards. Each shard runs its own segments through the single-segment
runners, and the candidates meet on the first device, in an
``all_gather`` across processes and one exact (score, doc) re-rank
(``sharded.py``).
"""

from iresearch_tpu_torch.parallel.sharded import Mesh, ShardedSearcher, make_mesh

__all__ = ["Mesh", "ShardedSearcher", "make_mesh"]
