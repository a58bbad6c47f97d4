"""Benchmark / utility CLI (reference: utils/ 'iresearch-benchmarks').

Modes mirror utils/main.cpp: ``put`` (multithreaded line-doc indexer,
index-put.cpp:359), ``search`` (luceneutil task-file query bench,
index-search.cpp:490), ``dump`` (index-dump.cpp), ``convert``
(index-convert.cpp). Run as ``python -m iresearch_tpu_torch.cli <mode> ...``.

A copy of ``iresearch_tpu/cli`` over the port's writer, reader and
executor: the flags, output lines, CSV and metrics are the JAX CLI's.
``put``, ``search`` and ``convert`` also take ``--device`` (the card
unless named, ``cpu`` in the tests), the counterpart of the
``JAX_PLATFORMS`` setting the JAX CLI obeys.
"""
