"""Host layers copied from ``iresearch_tpu/store``."""
