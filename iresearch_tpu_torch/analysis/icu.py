"""Locale-true collation sort keys via the system ICU (ctypes).

The reference builds collation tokens from icu::Collator::getSortKey
with full locale tailoring (collation_token_stream.cpp:65-80): under
Swedish rules å/ä/ö sort AFTER z, under German they interleave with
a/o/u — orderings a bytewise NFKD-casefold key cannot reproduce. This
module binds the C API (ucol_open / ucol_getSortKey) of whatever
libicui18n the image ships, following the same optional-shared-lib
pattern as liblz4/libcrypto (store/codecs.py): present -> locale-true
keys, absent -> callers fall back (analyzers.CollationAnalyzer keeps
the NFKD key and bumps a cap counter).

ICU versions its C symbols (ucol_open_72, ...); the suffix is derived
from the soname we managed to load, then verified by symbol lookup.

A copy of ``iresearch_tpu/analysis/icu.py``.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import threading
from typing import Dict, Optional

_lock = threading.Lock()
_icu = None  # lazily-initialized _ICU or False (= unavailable)


class _ICU:
    def __init__(self, lib: ctypes.CDLL, suffix: str) -> None:
        self._lib = lib
        self._open = getattr(lib, "ucol_open" + suffix)
        self._open.restype = ctypes.c_void_p
        self._open.argtypes = (ctypes.c_char_p, ctypes.POINTER(ctypes.c_int))
        self._get_key = getattr(lib, "ucol_getSortKey" + suffix)
        self._get_key.restype = ctypes.c_int32
        self._get_key.argtypes = (
            ctypes.c_void_p,
            ctypes.c_void_p,  # const UChar* (utf-16 code units)
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int32,
        )
        self._collators: Dict[str, int] = {}

    def collator(self, locale: str) -> Optional[int]:
        """A process-lifetime UCollator* for the locale (never closed:
        collators are tiny and reused per analyzer registry entry)."""
        with _lock:
            c = self._collators.get(locale)
            if c is not None:
                return c or None
            status = ctypes.c_int(0)
            c = self._open(locale.encode(), ctypes.byref(status))
            # status > 0 = failure; negative values are warnings (e.g.
            # U_USING_DEFAULT_WARNING for an unknown locale, which still
            # yields root-collation keys — the reference accepts those)
            if not c or status.value > 0:
                c = 0
            self._collators[locale] = c or 0
            return c or None

    def sort_key(self, coll: int, text: str) -> bytes:
        """Locale-tailored sort key (binary-comparable, NUL-terminated —
        identical semantics to icu::Collator::getSortKey)."""
        u16 = text.encode("utf-16-le")
        n = len(u16) // 2
        cap = max(8, 4 * n + 8)
        for _ in range(2):
            buf = (ctypes.c_uint8 * cap)()
            need = self._get_key(coll, u16, n, buf, cap)
            if need <= cap:
                return bytes(buf[: max(need, 0)])
            cap = need
        return bytes(buf[:cap])  # unreachable: second pass always fits


def get_icu() -> Optional[_ICU]:
    """The process ICU binding, or None when no usable libicui18n."""
    global _icu
    if _icu is not None:
        return _icu or None
    with _lock:
        if _icu is not None:
            return _icu or None
        found = None
        names = []
        so = ctypes.util.find_library("icui18n")
        if so:
            names.append(so)
        names += ["libicui18n.so"] + [
            f"libicui18n.so.{v}" for v in range(80, 55, -1)
        ]
        for name in names:
            try:
                lib = ctypes.CDLL(name)
            except OSError:
                continue
            # derive the symbol suffix from the soname version, then
            # verify; fall back to probing known suffixes
            cands = [""]
            ver = name.rsplit(".", 1)[-1]
            if ver.isdigit():
                cands.insert(0, "_" + ver)
            else:
                cands += [f"_{v}" for v in range(80, 55, -1)]
            for suf in cands:
                if hasattr(lib, "ucol_open" + suf) and hasattr(
                    lib, "ucol_getSortKey" + suf
                ):
                    found = _ICU(lib, suf)
                    break
            if found:
                break
        _icu = found or False
    return _icu or None
