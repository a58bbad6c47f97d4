"""The JAX package's jax-free planner modules, imported without jax.

``iresearch_tpu/exec/__init__.py`` imports ``executor.py``, which imports
jax, so a plain ``import iresearch_tpu.exec.plan`` imports jax even though
``plan.py``, ``plancache.py`` and ``skyline.py`` are jax-free at their top
level. The port never imports jax, even where it is installed. This
module is the only place the port touches ``iresearch_tpu.exec``:

* if the package is already imported (a process that runs both
  packages, such as the tests), the three modules import from it;
* otherwise ``iresearch_tpu.exec`` is registered as a package whose
  ``__path__`` is the real directory and whose ``__init__.py`` runs only
  when a name of the package itself is first asked for (``DeviceQuery``,
  ``search_device``); submodules import under their real names.

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

    def __getattr__(attr: str):
        # dunders and submodule names stay with the import system; any
        # other name runs the real __init__ (which imports jax) once
        if attr.startswith("__") or os.path.exists(os.path.join(path, attr + ".py")):
            raise AttributeError(attr)
        del mod.__dict__["__getattr__"]
        init = os.path.join(path, "__init__.py")
        with open(init) as f:
            exec(compile(f.read(), init, "exec"), mod.__dict__)
        return getattr(mod, attr)

    mod.__getattr__ = __getattr__
    sys.modules[name] = mod
    iresearch_tpu.exec = mod


_register_bare_exec()

plan = importlib.import_module("iresearch_tpu.exec.plan")
plancache = importlib.import_module("iresearch_tpu.exec.plancache")
skyline = importlib.import_module("iresearch_tpu.exec.skyline")

__all__ = ["plan", "plancache", "skyline"]
