"""Shared utilities of the PyTorch port: structured logging, the quality
harness, benchmark statistics."""
