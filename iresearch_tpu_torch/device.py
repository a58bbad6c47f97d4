"""Device handling: the card unless the caller names another device.

The entry points (``DeviceQuery``, ``search_device``, ``QueryBatch``)
take a ``device``; without one they take ``require_cuda()``, which raises
where there is no card instead of continuing on the CPU. The tests pass
``device="cpu"``.
"""

from __future__ import annotations

import contextlib
import subprocess
import weakref
from typing import Any, Dict, Optional, Sequence, Tuple

import torch


def require_cuda() -> torch.device:
    """The first CUDA device; raises when PyTorch sees no card."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: torch.cuda.is_available() is False"
        )
    return torch.device("cuda", 0)


def describe(device: torch.device) -> Tuple[str, Optional[float]]:
    """(name, power limit in W) of a card: ``torch.cuda.get_device_name``
    and the limit that ``nvidia-smi`` reads (None where it cannot); the
    device's own name and None for any other device. A card set below its
    full power limit runs slower under load, so every measurement names
    both."""
    device = torch.device(device)
    if device.type != "cuda":
        return str(device), None
    index = torch.cuda.current_device() if device.index is None else device.index
    name = torch.cuda.get_device_name(index)
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout
        return name, float(out.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return name, None


def runs_plain(t: torch.Tensor) -> bool:
    """True when a kernel wrapper must take its plain version: the tensor
    lies on the CPU. CUDA tensors launch the kernel; any other device
    raises."""
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"no kernel for device {t.device}")


def check_tensor(t: torch.Tensor, name: str, dtype, device, ndim: int):
    """Raise unless ``t`` has this dtype, device, rank and is contiguous."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: rank {t.dim()}, expected {ndim}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def current_card(device: torch.device):
    """A context in which ``device``, where it is a card, is the current
    card (``torch.cuda.device``, which switches only where another card is
    current, and back after); nothing for the CPU. Work issued on a card's
    current stream, a kernel's foreign launch, a graph's capture or replay,
    must run with that card current."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def raw_stream(device: torch.device) -> int:
    """The handle of PyTorch's current CUDA stream on ``device``, for a
    kernel's foreign call."""
    fast = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if fast is not None and device.index is not None:
        return fast(device.index)
    return torch.cuda.current_stream(device).cuda_stream


class CheckedSets:
    """What a kernel wrapper worked out for a set of long-lived tensors
    (a segment's pools): that they passed its checks, and the foreign
    call's arguments built from them.

    A set is known by the identity of its tensors, held through weak
    references, so a tensor that takes a dead one's ``id`` is checked
    anew and nothing is kept alive. The pools are never resized or
    re-pointed after upload, which is what makes the remembered
    ``data_ptr()`` values safe. The entries unused for longest make room
    for new ones, so sets of short-lived tensors (one call's row windows)
    pass through without growing it or pushing out the pools."""

    def __init__(self, size: int = 64) -> None:
        self._size = size
        self._sets: Dict[tuple, tuple] = {}

    def get(self, tensors: Sequence[torch.Tensor], static: tuple = ()) -> Optional[Any]:
        key = (tuple(map(id, tensors)), static)
        entry = self._sets.get(key)
        if entry is not None and all(r() is t for r, t in zip(entry[0], tensors)):
            self._sets[key] = self._sets.pop(key)  # the newest again
            return entry[1]
        return None

    def put(self, tensors: Sequence[torch.Tensor], static: tuple, value: Any) -> Any:
        if len(self._sets) >= self._size:
            del self._sets[next(iter(self._sets))]
        refs = tuple(weakref.ref(t) for t in tensors)
        self._sets[(tuple(map(id, tensors)), static)] = (refs, value)
        return value
