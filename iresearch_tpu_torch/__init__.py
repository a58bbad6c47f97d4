"""iresearch_tpu_torch — the PyTorch + CUDA port of iresearch_tpu.

The port runs the batched BM25 top-k search path (``exec.batch.QueryBatch``)
on an NVIDIA H100. It reuses the JAX package's host layers (store, formats,
analysis, index writer/reader, ``search/*``, the planner) by import and
replaces everything that touched a device: segment residency, the three
executor tiers of the batch path (skyline, dslice, fused scan) and their
three Pallas kernels, which are hand-written CUDA C++ here
(``kernels/csrc/irs_kernels.cu``).

Conventions:

* the caller passes the ``torch.device``; nothing picks one quietly;
* every kernel wrapper runs its plain PyTorch version for CPU tensors and
  launches the CUDA kernel (or raises) for CUDA tensors;
* this package never imports ``jax``.
"""

__version__ = "0.1.0"
