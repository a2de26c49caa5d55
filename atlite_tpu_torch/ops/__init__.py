"""Hand-written CUDA kernels of the PyTorch port and their wrappers.

Sources live in ``csrc/``; ``_build`` compiles them at first use.
"""
