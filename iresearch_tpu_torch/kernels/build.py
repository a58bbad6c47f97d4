"""nvcc build of ``csrc/*.cu`` into a content-addressed shared library.

The library is a plain C interface bound with ctypes (no PyTorch headers,
so ``nvcc`` takes seconds). It is named after a hash of the sources and
flags, so a stale build is never loaded, and built on first use into
``_build/`` beside this file (ignored by git). A failed build raises;
nothing falls back to another implementation.

Every wrapper adds one to its kernel's launch count where it launches the
kernel, so a run can show that the main path went through the kernels. A
fused pass's graph (``exec/batch.py``) launches the kernels that its
capture recorded: the capture counts them apart, and each replay adds them.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

KERNELS = (
    "dense_scan_rowmax", "dma_row_slices", "decode_rows", "decode_score_rows",
    "topk_docs",
)
_launches: Dict[str, int] = dict.fromkeys(KERNELS, 0)
_apart: Optional[Dict[str, int]] = None


def count_launch(name: str, n: int = 1) -> None:
    """Add ``n`` launches of kernel ``name``: one from its wrapper, or a
    replayed graph's launches of it (``exec/batch.py:_FusedPass``)."""
    (_launches if _apart is None else _apart)[name] += n


@contextlib.contextmanager
def counted_apart():
    """Count the block's launches into the dict it yields, not into
    ``launch_counts()``: a graph's capture records its kernels, which run
    at each replay, where they are counted."""
    global _apart
    saved, _apart = _apart, dict.fromkeys(KERNELS, 0)
    try:
        yield _apart
    finally:
        _apart = saved


def launch_counts() -> Dict[str, int]:
    return dict(_launches)


def reset_launch_counts() -> None:
    for name in _launches:
        _launches[name] = 0


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libirs_kernels_{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin)")
    return path


def available() -> bool:
    """True where the kernels can build and run: PyTorch sees a card and
    ``nvcc`` is found."""
    import torch

    try:
        _nvcc()
    except RuntimeError:
        return False
    return torch.cuda.is_available()


def _compile(so: Path) -> float:
    """nvcc -> ``so`` (atomic rename); returns the seconds it took. The
    compiler's output (``-Xptxas -v``: registers, spills) goes to a
    ``.log`` beside the library."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, _sources())]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    so.with_suffix(".log").write_text(
        " ".join(cmd) + "\n" + r.stdout + r.stderr
    )
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({r.returncode}):\n{r.stderr[-4000:]}"
        )
    os.replace(tmp, so)
    return seconds


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    LL = ctypes.c_longlong
    PP = ctypes.POINTER(ctypes.c_void_p)
    PI = ctypes.POINTER(ctypes.c_int)
    PLL = ctypes.POINTER(ctypes.c_longlong)
    lib.irs_dense_scan_rowmax.argtypes = [
        PP, PLL, PI, I, P, P, P, I, I, I, I, F, F, F, I, I, P, P, P,
    ]
    lib.irs_dma_row_slices.argtypes = [PP, PLL, PI, I, P, I, I, P, P]
    lib.irs_decode_rows.argtypes = [
        P, P, P, P, P, LL, LL, I, I, I, P, P, P,
    ]
    lib.irs_decode_score_rows.argtypes = [
        P, P, P, P, P, LL, LL, I, I, I,  # as irs_decode_rows
        P, P, LL, I, P, I,  # nrm_words, rows_n, nn_rows, bn, norms, nd_pad
        P, P, F, I, F, F,  # w, avgdl_dev, avgdl, kind, kb, c0
        P, P, P, P, P,  # docs, scores, matched, dl, stream
    ]
    lib.irs_topk_docs.argtypes = [
        P, LL, LL, P, LL, LL, I,  # scores, strides; docs, strides, kind
        LL, LL, I, I, P, P, P,  # Q, n, tiles, k, out_vals, out_docs, stream
    ]
    lib.irs_topk_sort.argtypes = [
        P, P, I, LL, LL,  # vals, docs, kind, Q, k
        P, P, P, P, P,  # keys, pos, out_vals, out_docs, stream
    ]
    lib.irs_noop.argtypes = [P]
    lib.irs_capture_nodes.argtypes = [P, PLL]
    for fn in (
        lib.irs_dense_scan_rowmax, lib.irs_dma_row_slices,
        lib.irs_decode_rows, lib.irs_decode_score_rows, lib.irs_topk_docs,
        lib.irs_topk_sort,
        lib.irs_noop, lib.irs_capture_nodes,
    ):
        fn.restype = ctypes.c_int
    lib.irs_error_string.argtypes = [I]
    lib.irs_error_string.restype = ctypes.c_char_p
    return lib


_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None  # nvcc time of this process's build


def library() -> ctypes.CDLL:
    """The bound kernel library, compiled first if this source hash has
    no build yet."""
    global _lib, build_seconds
    with _lock:
        if _lib is None:
            so = library_path()
            build_seconds = 0.0 if so.exists() else _compile(so)
            _lib = _bind(ctypes.CDLL(str(so)))
        return _lib


def check(lib: ctypes.CDLL, rc: int, name: str) -> None:
    """Raise when a kernel entry point reported a CUDA error."""
    if rc != 0:
        msg = lib.irs_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")


def launch_noop(stream) -> None:
    """Launch the library's empty kernel on ``stream`` (a
    ``torch.cuda.Stream``), its card current: what one launch costs the
    device, for a timing's floor."""
    import torch

    lib = library()
    with torch.cuda.device(stream.device):
        check(lib, lib.irs_noop(stream.cuda_stream), "noop")


def capture_nodes(stream) -> int:
    """The nodes of the CUDA graph being captured on ``stream`` (a
    ``torch.cuda.Stream``, its card made current), so far."""
    import torch

    lib = library()
    n = ctypes.c_longlong(0)
    with torch.cuda.device(stream.device):
        rc = lib.irs_capture_nodes(stream.cuda_stream, ctypes.byref(n))
    check(lib, rc, "capture_nodes")
    return n.value
