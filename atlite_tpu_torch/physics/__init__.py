"""Physics converters of the PyTorch port: plain tensor functions."""
