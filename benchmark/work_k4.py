"""The least work of the program's top-k select (K4,
``kernels/csrc/irs_topk.cu``: ``k4_topk_docs``, and above 4,096 winners
``k4_sort_runs`` and ``k4_merge``), from the call shapes that the program
notes on its fused spans (``exec/batch.py``: ``k4`` of ``fused.replay``
and ``fused.capture``): each byte a call needs read or written once,
whatever the kernel reads again over its launches (``work.py`` counts the
dense scan's the same way)."""

from __future__ import annotations


def k4_bytes(q: int, n: int, k: int, doc_bytes: int) -> int:
    """Bytes one select over ``q`` rows of ``n`` entries needs: each f32
    score and, where docs are given (``doc_bytes`` 4 or 8; 0 ranks by
    position), each doc read once, and the ``k`` winners of each row
    written once, an f32 score and a doc (an int32 position where none
    are given)."""
    q, n, k, doc_bytes = int(q), int(n), int(k), int(doc_bytes)
    return q * n * (4 + doc_bytes) + q * k * (4 + max(4, doc_bytes))
