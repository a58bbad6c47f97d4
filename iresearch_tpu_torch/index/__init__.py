"""Torch counterparts of ``iresearch_tpu.index`` device residency."""
