"""Device handling: the card unless the caller names another device.

The entry points (``DeviceQuery``, ``search_device``, ``QueryBatch``)
take a ``device``; without one they take ``require_cuda()``, which raises
where there is no card instead of continuing on the CPU. The tests pass
``device="cpu"``.
"""

from __future__ import annotations

import torch


def require_cuda() -> torch.device:
    """The first CUDA device; raises when PyTorch sees no card."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: torch.cuda.is_available() is False"
        )
    return torch.device("cuda", 0)


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
