"""Storage layer: copies of ``iresearch_tpu/store``."""

from iresearch_tpu_torch.store.directory import (
    Directory,
    FSDirectory,
    MemoryDirectory,
    MMapDirectory,
    IndexLock,
    LockObtainError,
)
from iresearch_tpu_torch.store.blobpack import BlobPackWriter, BlobPackReader

__all__ = [
    "Directory",
    "FSDirectory",
    "MemoryDirectory",
    "MMapDirectory",
    "IndexLock",
    "LockObtainError",
    "BlobPackWriter",
    "BlobPackReader",
]
