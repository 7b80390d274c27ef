"""Planted sparse-code sample stream (the serving workload).

Port of `sparse_stream` in src/repro/data/synthetic.py, giving the same
numbers for the same arguments.  The JAX version draws the planted
dictionary as one float64 normal array and casts it, which at the
production width (M = 8192, K = 262144) is 17 GB on the host before the
cast.  Here it is drawn in row chunks into a preallocated float32 array
from the same Generator: numpy's stream is sequential, so the values are
bit for bit the same, and the host holds one float32 copy.
"""

from __future__ import annotations

import numpy as np

_CHUNK_VALUES = 1 << 24  # float64 values drawn per chunk (128 MiB)


def planted_dictionary(rng: np.random.Generator, m: int, k: int, nonneg: bool) -> np.ndarray:
    """(m, k) float32 unit-norm columns: rng.normal(size=(m, k)) drawn in
    row chunks, cast, optionally made nonnegative, then column-normalised."""
    W0 = np.empty((m, k), np.float32)
    rows = max(1, _CHUNK_VALUES // max(k, 1))
    for r in range(0, m, rows):
        W0[r:r + rows] = rng.normal(size=(min(rows, m - r), k))
    if nonneg:
        np.abs(W0, out=W0)
    W0 /= np.linalg.norm(W0, axis=0, keepdims=True)
    return W0


def sparse_stream(
    n: int,
    m: int = 32,
    k_true: int = 48,
    sparsity: int = 3,
    noise: float = 0.01,
    nonneg: bool = False,
    seed: int = 0,
    return_dictionary: bool = False,
):
    """(n, m) stream of samples x = W0 y + noise with y `sparsity`-sparse;
    with `return_dictionary=True` also the planted W0 (m, k_true)."""
    rng = np.random.default_rng(seed)
    W0 = planted_dictionary(rng, m, k_true, nonneg)
    Y = np.zeros((n, k_true), np.float32)
    for i in range(n):
        idx = rng.choice(k_true, sparsity, replace=False)
        sign = 1.0 if nonneg else rng.choice([-1.0, 1.0], sparsity)
        Y[i, idx] = rng.uniform(0.5, 1.5, sparsity) * sign
    X = (Y @ W0.T + noise * rng.standard_normal((n, m)).astype(np.float32)).astype(
        np.float32
    )
    if nonneg:
        X = np.abs(X)
    if return_dictionary:
        return X, W0
    return X
