"""Dataset generators of the PyTorch port."""
