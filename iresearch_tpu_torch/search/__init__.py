"""Torch counterparts of ``iresearch_tpu.search`` device code."""
