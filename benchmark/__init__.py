"""The benchmark of ``iresearch_tpu_torch`` on one NVIDIA H100.

``python -m benchmark.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line. Everything that belongs to one configuration, traffic mix or
per-layer metric is a file of its own that the harness finds by name:
``configs/<config>.json``, ``traffic/<mix>.json`` (naming a module of
``drivers/``), ``layer_metrics/<metric>.py`` and ``references/<name>.py``.

The yardstick lives here and takes nothing from the program but the
system under test: the corpus law (``corpus.py``), the query generator
(``traffic.py``), the plain BM25 reference (``references/bm25.py``), the
comparison that decides ``correct`` (``checks.py``), the kernels' byte
counts and the card's peaks (``work.py``) and the reading of the device
trace (``trace.py``). Nothing here imports ``jax`` or ``iresearch_tpu``.
"""
