"""Hand-written Hopper kernels of the PyTorch port, each beside its plain
PyTorch version (ref.py) and its checked wrapper (ops.py)."""
