"""Device lexical (BM25) arm of the PyTorch port."""
