"""The card's peaks and the least work of the program's kernels.

Peaks are NVIDIA's published figures for one H100 SXM at its 700 W limit
(``PERF.md`` gives each card's power limit beside every share). The byte
count of the dense scan (K1, ``kernels/csrc/irs_kernels.cu``
``k1_dense_scan_rowmax``) is a frozen copy of the repo's
``chip_smoke.py:k1_work``: what the scan needs on one call's inputs, each
byte read or written once, whatever the kernel reads again.
"""

from __future__ import annotations

import numpy as np

HBM_BYTES_PER_S = 3.35e12


def k1_bytes(pools, starts, ws, norms) -> int:
    """Bytes one dense scan over ``Q`` queries and ``S`` spans needs: each
    span's distinct grid-row ranges (``ndrows`` rows of its pool from
    each distinct start), the norms, the starts and weights read once,
    and the row maxima and their lanes (f32 and i32 ``[Q, ndrows]``)
    written once."""
    q = starts.shape[0]
    ndrows = norms.shape[0]
    st = starts.cpu().numpy()
    nbytes = norms.numel() * norms.element_size()
    nbytes += starts.numel() * starts.element_size() + ws.numel() * ws.element_size()
    nbytes += q * ndrows * 8
    for s, pool in enumerate(pools):
        row = pool.shape[1] * pool.element_size()
        nbytes += len(np.unique(st[:, s])) * ndrows * row
    return int(nbytes)


def least_seconds(nbytes: float) -> float:
    """The least time of a call bound by memory: its bytes over the rate."""
    return nbytes / HBM_BYTES_PER_S
