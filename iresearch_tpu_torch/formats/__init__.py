"""The port's segment formats: copies of ``iresearch_tpu/formats`` plus the torch unpack."""
