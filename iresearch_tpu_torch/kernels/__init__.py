"""CUDA kernels of the port: ``csrc/*.cu`` and their nvcc build and ctypes
binding (``build.py``). Nothing here builds at import: the CPU tests import
every module."""
