"""Fused dual step S = nu W, Y = T(S)/delta, G = Y W^T (CUDA kernel + plain version)."""
