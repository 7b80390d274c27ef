"""Agent network topologies and doubly-stochastic combination matrices.

A copy of the numpy subset of src/repro/core/topology.py that the static
gossip modes use: adjacencies (ring, torus, complete, connected
Erdos-Renyi), the Metropolis / uniform / constant-weight ring combiners,
their checks, and `make_topology` for the undirected kinds.  The Erdos draw
makes the same numpy RNG calls as the JAX package, so both sides build the
same graph from the same seed.  Connectivity is a breadth-first search.
"""

from __future__ import annotations

import numpy as np

GRAPH_KINDS = ("ring", "ring_metropolis", "torus", "erdos", "full")


def ring_adjacency(n: int) -> np.ndarray:
    """Cycle graph C_n (each agent talks to 2 neighbors)."""
    a = np.zeros((n, n), dtype=bool)
    for i in range(n):
        a[i, (i + 1) % n] = True
        a[(i + 1) % n, i] = True
    if n == 1:
        a[0, 0] = False
    return a


def torus_adjacency(rows: int, cols: int) -> np.ndarray:
    """2-D torus (each agent talks to 4 neighbors)."""
    n = rows * cols
    a = np.zeros((n, n), dtype=bool)

    def idx(r, c):
        return (r % rows) * cols + (c % cols)

    for r in range(rows):
        for c in range(cols):
            i = idx(r, c)
            for j in (idx(r + 1, c), idx(r - 1, c), idx(r, c + 1), idx(r, c - 1)):
                if j != i:
                    a[i, j] = True
                    a[j, i] = True
    return a


def fully_connected_adjacency(n: int) -> np.ndarray:
    """Complete graph K_n (n, n) bool adjacency."""
    a = np.ones((n, n), dtype=bool)
    np.fill_diagonal(a, False)
    return a


def erdos_renyi_adjacency(n: int, p: float = 0.5, seed: int = 0) -> np.ndarray:
    """Connected Erdos-Renyi graph (resampled until connected), as in the paper."""
    rng = np.random.default_rng(seed)
    for _ in range(1000):
        a = rng.random((n, n)) < p
        a = np.triu(a, 1)
        a = a | a.T
        if is_connected(a):
            return a
    raise RuntimeError(f"could not sample a connected G({n},{p}) graph")


def is_connected(adj: np.ndarray) -> bool:
    """Whether the (n, n) bool adjacency is one connected component."""
    n = adj.shape[0]
    seen = {0}
    frontier = [0]
    while frontier:
        i = frontier.pop()
        for j in np.nonzero(adj[i])[0]:
            if int(j) not in seen:
                seen.add(int(j))
                frontier.append(int(j))
    return len(seen) == n


def metropolis_weights(adj: np.ndarray) -> np.ndarray:
    """Metropolis-Hastings combination matrix (doubly stochastic):
    a_{lk} = 1 / (1 + max(d_l, d_k)) for neighbors, diagonal absorbs the slack."""
    n = adj.shape[0]
    deg = adj.sum(axis=1)
    a = np.zeros((n, n), dtype=np.float64)
    for i in range(n):
        for j in np.nonzero(adj[i])[0]:
            a[i, j] = 1.0 / (1.0 + max(deg[i], deg[j]))
    np.fill_diagonal(a, 1.0 - a.sum(axis=1))
    return a


def uniform_weights(n: int) -> np.ndarray:
    """A = (1/n) 11^T, the fully-connected combiner (exact averaging)."""
    return np.full((n, n), 1.0 / n, dtype=np.float64)


def ring_weights(n: int, beta: float = 1.0 / 3.0) -> np.ndarray:
    """Constant-weight ring combiner [beta, 1-2beta, beta]; doubly
    stochastic for beta in [0, 1/2]."""
    if not 0.0 <= beta <= 0.5:
        raise ValueError(
            f"ring combiner weight beta={beta} outside the admissible range "
            f"[0, 1/2] (weights [beta, 1-2*beta, beta] must be nonnegative)"
        )
    if n == 1:
        return np.ones((1, 1))
    a = np.zeros((n, n))
    for i in range(n):
        a[i, i] = 1.0 - 2.0 * beta
        a[i, (i + 1) % n] += beta
        a[i, (i - 1) % n] += beta
    return a


def is_doubly_stochastic(a: np.ndarray, tol: float = 1e-9) -> bool:
    """Whether (n, n) A is nonnegative with rows AND columns summing to 1."""
    return (
        bool(np.all(a >= -tol))
        and bool(np.allclose(a.sum(axis=0), 1.0, atol=1e-7))
        and bool(np.allclose(a.sum(axis=1), 1.0, atol=1e-7))
    )


def mixing_rate(a: np.ndarray) -> float:
    """Second-largest singular value of A, the gossip contraction factor."""
    s = np.linalg.svd(a, compute_uv=False)
    return float(s[1]) if len(s) > 1 else 0.0


def torus_dims(n: int) -> tuple:
    """(rows, cols) of the most-square torus factorization of n."""
    rows = int(np.floor(np.sqrt(n)))
    while n % rows:
        rows -= 1
    return rows, n // rows


def make_topology(kind: str, n: int, *, p: float = 0.5, seed: int = 0,
                  beta: float = 1.0 / 3.0) -> np.ndarray:
    """Build an (n, n) doubly-stochastic combiner for `n` agents: "ring"
    (constant weight), "ring_metropolis", "torus", "erdos" or "full"."""
    if kind == "ring":
        return ring_weights(n, beta)
    if kind == "ring_metropolis":
        return metropolis_weights(ring_adjacency(n))
    if kind == "torus":
        return metropolis_weights(torus_adjacency(*torus_dims(n)))
    if kind == "erdos":
        return metropolis_weights(erdos_renyi_adjacency(n, p=p, seed=seed))
    if kind == "full":
        return uniform_weights(n)
    raise KeyError(f"unknown topology kind {kind!r}; options: {GRAPH_KINDS}")
