"""Host-side helpers (calendar math) of the PyTorch port."""
