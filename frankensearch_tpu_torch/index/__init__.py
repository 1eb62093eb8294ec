"""Device-resident vector indexes of the PyTorch port."""
