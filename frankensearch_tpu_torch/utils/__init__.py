"""Shared utilities of the PyTorch port: structured logging."""
