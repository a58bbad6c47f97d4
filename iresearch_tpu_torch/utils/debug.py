"""Debug assertions with a pluggable failure callback.

Reference: IRESEARCH_DEBUG / IRS_ASSERT with a settable callback
(core/utils/assert.{hpp,cpp}; CMakeLists.txt:92-94). Checks are free in
production (IRS_DEBUG unset => irs_assert is a no-op lambda); with
IRS_DEBUG=1 failures raise AssertionError or route to a registered
callback (the reference lets embedders turn asserts into logs).
"""

from __future__ import annotations

import os
from typing import Callable, Optional

_ENABLED = os.environ.get("IRS_DEBUG", "0") not in ("0", "")
_callback: Optional[Callable[[str], None]] = None


def set_assert_callback(cb: Optional[Callable[[str], None]]) -> None:
    """Route assertion failures to ``cb`` instead of raising
    (reference: SetAssertCallback). None restores raising."""
    global _callback
    _callback = cb


def assertions_enabled() -> bool:
    return _ENABLED


def _fail(msg: str) -> None:
    if _callback is not None:
        _callback(msg)
        return
    raise AssertionError(msg)


if _ENABLED:

    def irs_assert(cond: bool, msg: str = "assertion failed") -> None:
        if not cond:
            _fail(msg)

else:

    def irs_assert(cond: bool, msg: str = "assertion failed") -> None:  # noqa: ARG001
        pass
