"""The port's filters, expansion, host oracle and scorers (copies of ``iresearch_tpu/search``), with torch scoring."""
