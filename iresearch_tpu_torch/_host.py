"""The JAX package's jax-free planner modules, importable without jax.

``iresearch_tpu/exec/__init__.py`` imports ``executor.py``, which imports
jax, so a plain ``import iresearch_tpu.exec.plan`` needs jax even though
``plan.py``, ``plancache.py`` and ``skyline.py`` are jax-free at their top
level. This module is the only place the port touches
``iresearch_tpu.exec``:

* where jax is importable (the test process, which runs both packages),
  the three modules import as usual, so the JAX package is untouched;
* where it is not (the machine with the card), ``iresearch_tpu.exec`` is
  registered as a bare package whose ``__path__`` is the real directory
  and whose ``__init__.py`` is not run; the three files then import under
  their real names.

Nothing in the port may call code that reaches ``exec/executor.py``.
"""

from __future__ import annotations

import importlib
import importlib.machinery
import importlib.util
import os
import sys


def _register_bare_exec() -> None:
    name = "iresearch_tpu.exec"
    if name in sys.modules:
        return
    import iresearch_tpu

    path = os.path.join(os.path.dirname(iresearch_tpu.__file__), "exec")
    spec = importlib.machinery.ModuleSpec(name, None, is_package=True)
    spec.submodule_search_locations = [path]
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    iresearch_tpu.exec = mod


if importlib.util.find_spec("jax") is None:
    _register_bare_exec()

plan = importlib.import_module("iresearch_tpu.exec.plan")
plancache = importlib.import_module("iresearch_tpu.exec.plancache")
skyline = importlib.import_module("iresearch_tpu.exec.skyline")

__all__ = ["plan", "plancache", "skyline"]
