"""Device operations of the port: the four kernels (K1 ``dense_scan``, K2
``dma_gather``, K3 ``decode``, K4 ``topk``, the exact top-k).

Exports, against the JAX package's ``iresearch_tpu/ops``:

* ``decode_rows`` (K3's wrapper: the CUDA kernel on a CUDA tensor, its
  plain version on a CPU tensor) for ``decode_rows_pallas``;
* ``kernels_available`` (a card and ``nvcc`` are there, so the kernels
  can build and run) for ``pallas_available``.
"""

from iresearch_tpu_torch.kernels.build import available as kernels_available
from iresearch_tpu_torch.ops.decode import decode_rows

__all__ = ["decode_rows", "kernels_available"]
