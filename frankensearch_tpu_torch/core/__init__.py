"""Core contracts of the PyTorch port: types, config, errors, canonicalization,
query analysis (copies of the reference's jax-free modules)."""
