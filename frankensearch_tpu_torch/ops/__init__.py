"""Device ops of the PyTorch port: scans, kernels (K1/K2), BM25 and RRF tails."""
