"""Directory abstraction with atomic rename commit semantics.

Reference: core/store/directory.hpp:39-97 (create/open/rename/sync/list,
``index_lock`` single-writer lock), core/store/memory_directory.hpp:40,
core/store/fs_directory.hpp:33, core/store/directory_cleaner.hpp:41.

Design departures for the TPU engine:

* Files are whole-blob oriented (segment array packs, JSON manifests) rather
  than streamed: device upload wants one contiguous buffer per pool, so the
  stream/vint layer of the reference collapses into :mod:`blobpack`.
* ``rename`` is atomic on both implementations — it carries the two-phase
  commit (``pending_segments_<gen>`` -> ``segments_<gen>``) exactly like the
  reference's index_meta_writer (core/formats/formats_10.cpp:2826-2981).
"""

from __future__ import annotations

import os
import tempfile
import threading
from abc import ABC, abstractmethod
from typing import Dict, Iterable, List, Optional, Set


class LockObtainError(RuntimeError):
    """Raised when the single-writer index lock is already held."""


class IndexLock:
    """Single-writer lock handle (reference: directory.hpp:39-66)."""

    def __init__(self, release_fn) -> None:
        self._release = release_fn
        self._held = True

    def release(self) -> None:
        if self._held:
            self._held = False
            self._release()

    def __enter__(self) -> "IndexLock":
        return self

    def __exit__(self, *exc) -> None:
        self.release()


class Directory(ABC):
    """Abstract flat file namespace holding immutable index artifacts."""

    @abstractmethod
    def write(self, name: str, data: bytes) -> None:
        """Create/overwrite file ``name`` with ``data`` (not yet durable)."""

    @abstractmethod
    def read(self, name: str) -> bytes:
        """Read the full contents of ``name``; raises FileNotFoundError."""

    @abstractmethod
    def exists(self, name: str) -> bool: ...

    @abstractmethod
    def list(self) -> List[str]: ...

    @abstractmethod
    def remove(self, name: str) -> bool:
        """Delete ``name``; returns False if it did not exist."""

    @abstractmethod
    def rename(self, src: str, dst: str) -> None:
        """Atomically rename ``src`` to ``dst`` (the commit point primitive)."""

    @abstractmethod
    def sync(self, names: Iterable[str]) -> None:
        """Make the named files durable before the commit rename."""

    @abstractmethod
    def try_lock(self, name: str = "write.lock") -> Optional[IndexLock]:
        """Try to acquire the single-writer lock; None if already held."""

    def length(self, name: str) -> int:
        return len(self.read(name))

    # lazily-paged reads (reference: mmap_directory.hpp:33 + IOAdvice).
    # Default: whole-file bytes; MMapDirectory returns an OS-paged buffer
    # so segment opens touch no data until a pool is first read.
    mapped_reads = False

    def read_mapped(self, name: str):
        return self.read(name)

    def lock(self, name: str = "write.lock") -> IndexLock:
        handle = self.try_lock(name)
        if handle is None:
            raise LockObtainError(f"index lock '{name}' is already held")
        return handle


class MemoryDirectory(Directory):
    """In-RAM directory (reference: memory_directory.hpp:40-299)."""

    def __init__(self) -> None:
        self._files: Dict[str, bytes] = {}
        self._locks: Set[str] = set()
        self._mutex = threading.Lock()

    def write(self, name: str, data: bytes) -> None:
        with self._mutex:
            self._files[name] = bytes(data)

    def read(self, name: str) -> bytes:
        with self._mutex:
            try:
                return self._files[name]
            except KeyError:
                raise FileNotFoundError(name) from None

    def exists(self, name: str) -> bool:
        with self._mutex:
            return name in self._files

    def list(self) -> List[str]:
        with self._mutex:
            return sorted(self._files)

    def remove(self, name: str) -> bool:
        with self._mutex:
            return self._files.pop(name, None) is not None

    def rename(self, src: str, dst: str) -> None:
        with self._mutex:
            if src not in self._files:
                raise FileNotFoundError(src)
            self._files[dst] = self._files.pop(src)

    def sync(self, names: Iterable[str]) -> None:
        for name in names:
            if not self.exists(name):
                raise FileNotFoundError(name)

    def try_lock(self, name: str = "write.lock") -> Optional[IndexLock]:
        with self._mutex:
            if name in self._locks:
                return None
            self._locks.add(name)

        def release() -> None:
            with self._mutex:
                self._locks.discard(name)

        return IndexLock(release)


class FSDirectory(Directory):
    """POSIX filesystem directory (reference: fs_directory.hpp:33).

    Writes go through a temp file + rename so a crashed write never leaves a
    torn file under its final name; ``sync`` fsyncs both the file and the
    containing directory entry.
    """

    def __init__(self, path: str) -> None:
        self._path = os.path.abspath(path)
        os.makedirs(self._path, exist_ok=True)
        self._lock_fds: Dict[str, int] = {}
        self._mutex = threading.Lock()

    @property
    def path(self) -> str:
        return self._path

    def _full(self, name: str) -> str:
        if "/" in name or name.startswith("."):
            raise ValueError(f"invalid index file name: {name!r}")
        return os.path.join(self._path, name)

    def write(self, name: str, data: bytes) -> None:
        full = self._full(name)
        fd, tmp = tempfile.mkstemp(prefix=".tmp-", dir=self._path)
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(data)
            os.replace(tmp, full)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    def read(self, name: str) -> bytes:
        with open(self._full(name), "rb") as f:
            return f.read()

    def exists(self, name: str) -> bool:
        return os.path.exists(self._full(name))

    def list(self) -> List[str]:
        return sorted(
            n
            for n in os.listdir(self._path)
            if not n.startswith(".tmp-") and os.path.isfile(os.path.join(self._path, n))
        )

    def remove(self, name: str) -> bool:
        try:
            os.unlink(self._full(name))
            return True
        except FileNotFoundError:
            return False

    def rename(self, src: str, dst: str) -> None:
        os.replace(self._full(src), self._full(dst))
        self._sync_dir()

    def sync(self, names: Iterable[str]) -> None:
        for name in names:
            fd = os.open(self._full(name), os.O_RDONLY)
            try:
                os.fsync(fd)
            finally:
                os.close(fd)
        self._sync_dir()

    def _sync_dir(self) -> None:
        fd = os.open(self._path, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)

    def try_lock(self, name: str = "write.lock") -> Optional[IndexLock]:
        import fcntl

        full = self._full(name)
        with self._mutex:
            if name in self._lock_fds:
                return None
            fd = os.open(full, os.O_CREAT | os.O_RDWR, 0o644)
            try:
                fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
            except OSError:
                os.close(fd)
                return None
            self._lock_fds[name] = fd

        def release() -> None:
            with self._mutex:
                lfd = self._lock_fds.pop(name, None)
            if lfd is not None:
                fcntl.flock(lfd, fcntl.LOCK_UN)
                os.close(lfd)

        return IndexLock(release)


class MMapDirectory(FSDirectory):
    """mmap-backed reads (reference: mmap_directory.hpp:33).

    ``read_mapped`` returns an OS-paged buffer: opening a segment
    materializes nothing — pools fault in on first touch, so an index
    with one queried field loads only that field's pages
    (data_input.hpp:115 / IOAdvice semantics). Whole-file CRC checks are
    skipped on mapped opens (they would fault in every page); the
    blobpack header magic is still validated.
    """

    mapped_reads = True

    def read_mapped(self, name: str):
        import mmap as _mmap

        with open(self._full(name), "rb") as f:
            if os.fstat(f.fileno()).st_size == 0:
                return b""
            # the mapping outlives the fd (POSIX)
            return _mmap.mmap(
                f.fileno(), 0, access=_mmap.ACCESS_READ
            )


def clean_directory(directory: Directory, referenced: Set[str]) -> List[str]:
    """Remove index files not referenced by any live snapshot.

    Reference: core/store/directory_cleaner.hpp:41 — refcount-aware GC of
    orphans left by crashes or failed/rolled-back commits. The caller passes
    the union of files referenced by every retained generation.
    """
    removed = []
    for name in directory.list():
        if name in referenced or name.endswith(".lock"):
            continue
        if directory.remove(name):
            removed.append(name)
    return removed
