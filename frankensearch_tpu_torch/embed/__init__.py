"""Embedders of the PyTorch port: the hash embedder and the query cache."""
