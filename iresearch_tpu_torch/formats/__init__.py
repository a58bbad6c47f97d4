"""Torch counterparts of ``iresearch_tpu.formats`` device code."""
