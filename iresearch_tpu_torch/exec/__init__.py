"""Query execution on torch tensors, and the planner and plan cache copied from ``iresearch_tpu/exec``."""
