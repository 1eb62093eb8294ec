"""Search orchestration of the PyTorch port."""
