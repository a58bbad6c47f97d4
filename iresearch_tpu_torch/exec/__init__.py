"""Query execution on torch tensors, and the planner and plan cache copied
from ``iresearch_tpu/exec``.

A filter compiles into a block-scan plan (``exec/plan.py``) that runs on a
torch device: the single query (``executor.DeviceQuery``,
``search_device``), the batch (``batch.QueryBatch``) and the index-wide
merge (``segmerge.py``).
"""

from iresearch_tpu_torch.exec.executor import DeviceQuery, search_device

__all__ = ["DeviceQuery", "search_device"]
