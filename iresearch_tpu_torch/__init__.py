"""iresearch_tpu_torch — the PyTorch + CUDA port of iresearch_tpu.

The port runs the search engine on an NVIDIA H100: ingest (the
``analysis`` analyzers and ``index.writer.IndexWriter``, whose flushes
invert on the card), the batched BM25 top-k path (``exec.batch.QueryBatch``)
and the single-query executor (``exec.executor.DeviceQuery``,
``search_device``). It carries its own copy of every host layer it needs
(``analysis``, ``formats``, the ``index`` reader, writer, merge and
consolidation, ``search`` filters/expansion/oracle/scorers, the ``exec``
planner and plan cache, the ``native`` loader of the shared C++ library in
``native/``), each under the JAX package module's path and name, and
replaces everything that touched a device: segment residency, the
executor tiers and the three Pallas kernels, which are hand-written CUDA
C++ here (``kernels/csrc/irs_kernels.cu``).

Conventions:

* entry points run on the card unless the caller names a ``device``;
* every kernel wrapper runs its plain PyTorch version for CPU tensors and
  launches the CUDA kernel (or raises) for CUDA tensors;
* this package imports neither ``jax`` nor ``iresearch_tpu``; a segment
  file written by either package opens in the other
  (``index.segment.carry_segment``).
"""

__version__ = "0.1.0"

_LAZY = {
    "IndexWriter": ("iresearch_tpu_torch.index.writer", "IndexWriter"),
    "IndexWriterOptions": ("iresearch_tpu_torch.index.writer", "IndexWriterOptions"),
    "DirectoryReader": ("iresearch_tpu_torch.index.reader", "DirectoryReader"),
    "Directory": ("iresearch_tpu_torch.store.directory", "Directory"),
    "FSDirectory": ("iresearch_tpu_torch.store.directory", "FSDirectory"),
    "MMapDirectory": ("iresearch_tpu_torch.store.directory", "MMapDirectory"),
    "MemoryDirectory": ("iresearch_tpu_torch.store.directory", "MemoryDirectory"),
}


def __getattr__(name):
    """Lazy top-level exports: ``import iresearch_tpu_torch`` imports no
    torch, touches no card and builds no kernel."""
    try:
        module, attr = _LAZY[name]
    except KeyError:
        raise AttributeError(name) from None
    import importlib

    value = getattr(importlib.import_module(module), attr)
    globals()[name] = value
    return value


__all__ = [
    "IndexWriter",
    "IndexWriterOptions",
    "DirectoryReader",
    "Directory",
    "FSDirectory",
    "MMapDirectory",
    "MemoryDirectory",
    "__version__",
]
