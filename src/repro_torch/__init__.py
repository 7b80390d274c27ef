"""PyTorch port of the distributed dictionary-learning system, for one
NVIDIA H100.

The JAX package `repro` is the reference; each module here names the JAX
module it ports.  All N agents live on one device, as the leading axis of
every tensor: atom blocks are (N, M, Kb), duals (N, B, M), codes (N, B, Kb).
Entry points run on the card unless the caller asks for the CPU
(`device.resolve_device`).  This package imports neither jax nor `repro`.
"""
