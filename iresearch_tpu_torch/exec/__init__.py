"""Batched query execution on torch tensors (``batch.QueryBatch``)."""
