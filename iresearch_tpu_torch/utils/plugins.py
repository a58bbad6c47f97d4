"""dlopen plugin loading for out-of-process analyzer extensions.

Reference: core/utils/register.hpp:78-117 — a registry ``get(key,
load_library=true)`` miss derives a shared-object filename from the key,
dlopens it, and the library self-registers; ``so_utils.hpp:load_libraries``
scans a directory for prefixed/suffixed plugin libraries. This engine's
analog uses a small versioned C ABI instead of C++ static initializers
(stable across compilers, loadable via ctypes):

    const char* irs_plugin_manifest(void);
        -> JSON {"abi": 1, "analyzers": ["name", ...]}
    long irs_plugin_tokenize(const char* analyzer,
                             const char* text, long text_len,
                             char* out, long cap);
        -> bytes written to `out` ('\\n'-separated terms, sequential
           positions), or -(needed) when cap is too small, or -1 on error.

``load_plugin(path)`` loads one library and registers its analyzers into
the in-process registry (analysis.get() then resolves them by name).
``load_plugins(dir)`` is the load_libraries analog. ``analysis.get``
falls back to ``$IRS_PLUGIN_PATH/libanalyzer-<name>.so`` on a registry
miss — the load_entry_from_so analog (register.hpp:113-117).

A sample plugin lives in native/sample_plugin.cpp (built by tests).

A copy of ``iresearch_tpu/utils/plugins.py``.
"""

from __future__ import annotations

import ctypes
import json
import os
from typing import Dict, List

_ABI = 1
_LOADED: Dict[str, ctypes.CDLL] = {}


class PluginError(RuntimeError):
    pass


def _bind(lib: ctypes.CDLL):
    lib.irs_plugin_manifest.restype = ctypes.c_char_p
    lib.irs_plugin_manifest.argtypes = []
    lib.irs_plugin_tokenize.restype = ctypes.c_long
    lib.irs_plugin_tokenize.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_long,
        ctypes.c_char_p, ctypes.c_long,
    ]


def _analyzer_base():
    from iresearch_tpu_torch.analysis.analyzers import Analyzer

    return Analyzer


class PluginAnalyzer(_analyzer_base()):
    """Analyzer backed by a plugin library's irs_plugin_tokenize."""

    def __init__(self, lib: ctypes.CDLL, name: str) -> None:
        self._lib = lib
        self._name = name.encode()

    def tokenize(self, text: str):
        from iresearch_tpu_torch.analysis.token import Token

        data = text.encode("utf-8")
        cap = max(256, 2 * len(data) + 64)
        for _ in range(2):
            buf = ctypes.create_string_buffer(cap)
            n = self._lib.irs_plugin_tokenize(
                self._name, data, len(data), buf, cap
            )
            if n >= 0:
                out: List[Token] = []
                if n:
                    for pos, term in enumerate(buf.raw[:n].split(b"\n")):
                        if term:
                            out.append(Token(term=term, position=pos))
                return out
            if n < -1:
                cap = -n  # retry with the reported size
                continue
            raise PluginError(f"plugin tokenize failed for {self._name!r}")
        raise PluginError("plugin tokenize retry exhausted")


def load_plugin(path: str) -> List[str]:
    """dlopen one plugin library; register and return its analyzer names."""
    path = os.path.abspath(path)
    if path in _LOADED:
        lib = _LOADED[path]
    else:
        try:
            lib = ctypes.CDLL(path)
        except OSError as e:  # load_library failure (so_utils.cpp)
            raise PluginError(f"cannot load plugin {path}: {e}") from e
        try:
            _bind(lib)
        except AttributeError as e:
            raise PluginError(f"{path} lacks the irs plugin ABI: {e}") from e
        _LOADED[path] = lib
    manifest = json.loads(lib.irs_plugin_manifest().decode())
    if manifest.get("abi") != _ABI:
        raise PluginError(
            f"{path}: plugin ABI {manifest.get('abi')} != supported {_ABI}"
        )
    from iresearch_tpu_torch.analysis import analyzers as _an

    names = list(manifest.get("analyzers", ()))
    for name in names:
        _an.register(name, lambda args, _n=name, _l=lib: PluginAnalyzer(_l, _n))
    return names


def load_plugins(directory: str, prefix: str = "libirs-", suffix: str = ".so") -> List[str]:
    """Scan a directory for plugin libraries (load_libraries analog)."""
    out: List[str] = []
    if not os.path.isdir(directory):
        return out
    for fn in sorted(os.listdir(directory)):
        if fn.startswith(prefix) and fn.endswith(suffix):
            out.extend(load_plugin(os.path.join(directory, fn)))
    return out


def try_load_for_key(kind: str, name: str) -> bool:
    """Registry-miss hook: $IRS_PLUGIN_PATH/lib<kind>-<name>.so
    (key_to_filename analog, register.hpp:107)."""
    root = os.environ.get("IRS_PLUGIN_PATH")
    if not root:
        return False
    path = os.path.join(root, f"lib{kind}-{name}.so")
    if not os.path.exists(path):
        return False
    try:
        return name in load_plugin(path)
    except PluginError:
        return False
