"""Host-side helpers (calendar math, the grid) of the PyTorch port."""
