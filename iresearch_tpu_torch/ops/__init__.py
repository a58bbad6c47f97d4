"""Device operations of the port: exact top-k and the three kernels
(K1 ``dense_scan``, K2 ``dma_gather``, K3 ``decode``)."""
