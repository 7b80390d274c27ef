"""Agent network topologies and their combination matrices.

A copy of the numpy code of src/repro/core/topology.py that the gossip
modes use (the port imports nothing of the JAX package):

* static combiners: adjacencies (ring, torus, complete, connected
  Erdos-Renyi), the Metropolis / uniform / constant-weight ring combiners,
  their checks, and `make_topology`, with the directed row-stochastic kinds
  ("dicycle", "distar") of the push-sum modes;
* time-varying sequences: `TopologySchedule` (a seeded periodic A_0, A_1,
  ...), `make_topology_schedule`, `fixed_schedule`, and seeded link
  failures over a schedule (`link_failure_schedule`);
* hierarchical combiners: `LevelSpec` / `parse_level_specs`, the N-level
  `KroneckerChain` A_{L-1} (x) ... (x) A_0 with per-level strides, and its
  two-level surface `HierarchicalTopology`;
* elastic growth and agent drain: `erdos_renyi_grow` enlarges a graph
  without rewiring the edges between existing agents, `shrink_adjacency`
  restricts one to the survivors (a ring over them unioned in when the
  induced subgraph disconnects), and the `grown` / `shrunk` methods of the
  schedules and chains re-derive every combiner at the new size (a chain
  and a hierarchy on their innermost model level only; link failures
  re-applied over the grown or shrunk base).

Every random draw makes the same numpy RNG calls as the JAX package, so
both sides build the same graphs and sequences from the same seeds, grown
and shrunk ones too.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

GRAPH_KINDS = ("ring", "ring_metropolis", "torus", "erdos", "full")
DIRECTED_KINDS = ("dicycle", "distar")


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


def erdos_renyi_grow(adj_old: np.ndarray, n_new: int, p: float = 0.5,
                     seed: int = 0) -> np.ndarray:
    """Grow a connected Erdos-Renyi graph to n_new agents without rewiring
    the existing ones: the top-left block is exactly `adj_old`, and only
    edges with an endpoint among the new agents are drawn (resampled until
    the grown graph is connected)."""
    adj_old = np.asarray(adj_old, dtype=bool)
    n_old = adj_old.shape[0]
    if n_new < n_old:
        raise ValueError(f"cannot grow from {n_old} agents down to {n_new}")
    if n_new == n_old:
        return adj_old.copy()
    rng = np.random.default_rng(seed)
    for _ in range(1000):
        a = np.zeros((n_new, n_new), dtype=bool)
        a[:n_old, :n_old] = adj_old
        cand = np.triu(rng.random((n_new, n_new)) < p, 1)
        cand[:n_old, :n_old] = False  # never touch existing-agent edges
        a |= cand | cand.T
        if is_connected(a):
            return a
    raise RuntimeError(f"could not grow a connected G({n_new},{p}) graph from {n_old} agents")


def _check_survivors(survivors: Sequence[int], n: int, what: str) -> Tuple[int, ...]:
    """Sorted survivor ranks, validated against n agents."""
    survivors = tuple(sorted(int(r) for r in survivors))
    if not survivors:
        raise ValueError(f"cannot shrink {what} to zero survivors")
    if len(set(survivors)) != len(survivors):
        raise ValueError(f"duplicate survivor ranks in {survivors}")
    if survivors[0] < 0 or survivors[-1] >= n:
        raise ValueError(f"survivor ranks {survivors} out of range for {what} of {n} agents")
    return survivors


def shrink_adjacency(adj: np.ndarray, survivors: Sequence[int]) -> np.ndarray:
    """The survivor-induced subgraph of `adj` (every edge between two
    survivors kept); if it is disconnected, the ring over the survivors is
    unioned in, a deterministic repair that adds at most two edges each."""
    adj = np.asarray(adj, dtype=bool)
    survivors = _check_survivors(survivors, adj.shape[0], "an adjacency")
    sub = adj[np.ix_(survivors, survivors)].copy()
    if not is_connected(sub):
        sub |= ring_adjacency(len(survivors))
    np.fill_diagonal(sub, False)
    return sub


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


def is_row_stochastic(a: np.ndarray, tol: float = 1e-9) -> bool:
    """Whether (n, n) A is nonnegative with rows summing to 1: mass
    conservation under nu_k = sum_l A[l, k] psi_l, all the push-sum modes
    need of a (possibly directed) combiner."""
    return (
        bool(np.all(a >= -tol))
        and bool(np.allclose(a.sum(axis=1), 1.0, atol=1e-7))
    )


def is_strongly_connected(adj: np.ndarray) -> bool:
    """Whether the (n, n) bool directed adjacency is strongly connected."""
    adj = np.asarray(adj, dtype=bool)
    n = adj.shape[0]
    if n == 1:
        return True

    def _reaches_all(a: np.ndarray) -> bool:
        seen = {0}
        frontier = [0]
        while frontier:
            i = frontier.pop()
            for j in np.nonzero(a[i])[0]:
                if int(j) not in seen:
                    seen.add(int(j))
                    frontier.append(int(j))
        return len(seen) == n

    return _reaches_all(adj) and _reaches_all(adj.T)


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


def dicycle_weights(n: int) -> np.ndarray:
    """Directed cycle: row i keeps 1/2 and ships 1/2 to (i+1) % n (doubly
    stochastic, one send per agent)."""
    if n == 1:
        return np.ones((1, 1))
    a = np.zeros((n, n))
    for i in range(n):
        a[i, i] = 0.5
        a[i, (i + 1) % n] += 0.5
    return a


def distar_weights(n: int) -> np.ndarray:
    """Directed star: hub row 0 averages over all n agents, leaf row i >= 1
    keeps 1/2 and ships 1/2 to the hub.  Row stochastic, not doubly
    stochastic for n >= 3: push-sum modes only."""
    if n == 1:
        return np.ones((1, 1))
    a = np.zeros((n, n))
    a[0, :] = 1.0 / n
    for i in range(1, n):
        a[i, i] = 0.5
        a[i, 0] = 0.5
    return a


def make_topology(kind: str, n: int, *, p: float = 0.5, seed: int = 0,
                  beta: float = 1.0 / 3.0) -> np.ndarray:
    """Build an (n, n) combiner for `n` agents.  Doubly stochastic: "ring"
    (constant weight), "ring_metropolis", "torus", "erdos", "full".
    Directed (row stochastic and strongly connected, push-sum modes only):
    "dicycle", "distar"."""
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
    if kind in DIRECTED_KINDS:
        a = dicycle_weights(n) if kind == "dicycle" else distar_weights(n)
        if not (is_row_stochastic(a) and is_strongly_connected(a > 1e-12)):
            raise AssertionError(f"directed kind {kind!r} broke its contract at n={n}")
        return a
    raise KeyError(f"unknown topology kind {kind!r}; options: "
                   f"{GRAPH_KINDS + DIRECTED_KINDS}")


# -- time-varying combiner sequences ---------------------------------------


def derive_seed(seed: int, *stream: int) -> int:
    """Deterministic child seed for stream position `stream` under `seed`
    (numpy SeedSequence, as the JAX package)."""
    return int(np.random.SeedSequence((int(seed),) + tuple(int(s) for s in stream))
               .generate_state(1)[0])


def _window_product(combiners: Sequence[np.ndarray]) -> np.ndarray:
    """A_0 A_1 ... A_{P-1} in float64 (shared by `windowed_mixing_rate` and
    the `window_combiner` methods)."""
    prod = np.eye(np.asarray(combiners[0]).shape[0])
    for a in combiners:
        prod = prod @ np.asarray(a, np.float64)
    return prod


def windowed_mixing_rate(combiners: Sequence[np.ndarray]) -> float:
    """Per-step contraction of a combiner window: sigma_2(A_0 ... A_{P-1})^(1/P);
    `mixing_rate(A)` for P = 1."""
    return float(mixing_rate(_window_product(combiners)) ** (1.0 / len(combiners)))


def _stacked_callable(combiners: Sequence[np.ndarray], device) -> Callable:
    """``A_t(t) -> (n, n)`` float32 tensor on `device`, periodic in t."""
    stack = torch.as_tensor(
        np.stack([np.asarray(a, np.float32) for a in combiners]), device=device
    )
    period = len(combiners)
    return lambda t: stack[int(t) % period]


@dataclasses.dataclass(frozen=True, eq=False)
class TopologySchedule:
    """A periodic, seeded sequence of doubly-stochastic combiners A_t: the
    combiner of diffusion iteration t is ``at(t) = combiners[t % period]``.

    Fields: `spec` (normalized spec string), `n` (agents), `kinds` (per-step
    combiner kind), `combiners` (per-step (n, n) A_t), `adjacencies`
    (per-step bool adjacency of graph-backed steps, else None), and the
    generator parameters `p`, `seed`, `beta`.  Every entry is validated
    doubly stochastic at construction."""

    spec: str
    n: int
    kinds: Tuple[str, ...]
    combiners: Tuple[np.ndarray, ...]
    adjacencies: Tuple[Optional[np.ndarray], ...]
    p: float = 0.5
    seed: int = 0
    beta: float = 1.0 / 3.0

    def __post_init__(self):
        if not self.combiners:
            raise ValueError("TopologySchedule needs at least one combiner")
        if len(self.kinds) != len(self.combiners):
            raise ValueError("kinds and combiners must have equal length")
        for t, a in enumerate(self.combiners):
            a = np.asarray(a)
            if a.shape != (self.n, self.n):
                raise ValueError(
                    f"combiner {t} has shape {a.shape}, expected {(self.n, self.n)}"
                )
            if not is_doubly_stochastic(a):
                raise ValueError(
                    f"combiner {t} (kind {self.kinds[t]!r}) of schedule "
                    f"{self.spec!r} is not doubly stochastic"
                )

    @property
    def period(self) -> int:
        """Number of distinct combiners before the sequence repeats."""
        return len(self.combiners)

    def at(self, t: int) -> np.ndarray:
        """The (n, n) combiner applied at diffusion iteration t."""
        return self.combiners[int(t) % self.period]

    def stacked(self) -> np.ndarray:
        """(period, n, n) float32 stack of the combiners."""
        return np.stack([np.asarray(a, np.float32) for a in self.combiners])

    def as_callable(self, device=None) -> Callable:
        """``A_t(t) -> (n, n)`` float32 tensor, the callable-A form of
        `core.inference.diffusion_infer`."""
        return _stacked_callable(self.combiners, device)

    def window_combiner(self) -> np.ndarray:
        """The effective one-period combiner A_0 A_1 ... A_{P-1} (doubly
        stochastic; what the time-varying coder's `combiner()` reports)."""
        return _window_product(self.combiners)

    def windowed_mixing_rate(self) -> float:
        """Per-step contraction sigma_2(window product)^(1/period)."""
        return windowed_mixing_rate(self.combiners)

    def _resized(self, n_new: int, erdos_adj: Callable, what: str) -> "TopologySchedule":
        """The schedule at n_new agents: each erdos step from
        `erdos_adj(i, adjacency)`, each structured kind re-derived at n_new;
        an explicit combiner has no generator and is refused."""
        kinds, combiners, adjs = [], [], []
        for i, kind in enumerate(self.kinds):
            if kind == "erdos" and self.adjacencies[i] is not None:
                adj = erdos_adj(i, self.adjacencies[i])
                combiners.append(metropolis_weights(adj))
                adjs.append(adj)
            elif kind in GRAPH_KINDS and kind != "erdos":
                combiners.append(make_topology(kind, n_new, p=self.p, seed=self.seed,
                                               beta=self.beta))
                adjs.append(_adjacency_for(kind, n_new))
            else:
                raise ValueError(
                    f"cannot {what} schedule step {i} of kind {kind!r}: it wraps an "
                    f"explicit combiner matrix with no generator; build the schedule via "
                    f"make_topology_schedule('fixed:<kind>', ...) so it can be re-derived"
                )
            kinds.append(kind)
        return TopologySchedule(spec=self.spec, n=n_new, kinds=tuple(kinds),
                                combiners=tuple(combiners), adjacencies=tuple(adjs),
                                p=self.p, seed=self.seed, beta=self.beta)

    def grown(self, n_new: int) -> "TopologySchedule":
        """The schedule for n_new agents (elastic growth): erdos steps grow
        by `erdos_renyi_grow` from stream (seed, step, n_new), so existing
        agents keep their neighbourhoods; structured kinds re-derive."""
        return self._resized(n_new, lambda i, adj: erdos_renyi_grow(
            adj, n_new, p=self.p, seed=derive_seed(self.seed, i, n_new)), "grow")

    def shrunk(self, survivors: Sequence[int]) -> "TopologySchedule":
        """The schedule for a surviving agent subset (drain): erdos steps
        restrict to the survivors (`shrink_adjacency`); structured kinds
        re-derive at the smaller size."""
        survivors = _check_survivors(survivors, self.n, "a schedule")
        return self._resized(len(survivors),
                             lambda i, adj: shrink_adjacency(adj, survivors), "shrink")


def _adjacency_for(kind: str, n: int) -> Optional[np.ndarray]:
    """Adjacency of a structured kind (None for the dense "full")."""
    if kind in ("ring", "ring_metropolis"):
        return ring_adjacency(n)
    if kind == "torus":
        return torus_adjacency(*torus_dims(n))
    return None


# -- hierarchical (N-level) combiners: A_{L-1} (x) ... (x) A_0 --------------

LEVEL_WIRES = ("fp32", "q8")


@dataclasses.dataclass(frozen=True)
class LevelSpec:
    """One hop of a Kronecker chain: combiner `kind`, `gossip_every` (fire
    only at iterations t with t % gossip_every == 0), `wire` ("fp32" or
    "q8", int8 + per-row scale with error feedback), `stale` (combine with
    the previous firing's messages; outermost level only) and `axis` (the
    level's name; None = "model" for level 0, "pod" for level 1, "pod<i>"
    above)."""

    kind: str
    gossip_every: int = 1
    wire: str = "fp32"
    stale: bool = False
    axis: Optional[str] = None

    def __post_init__(self):
        if self.gossip_every < 1:
            raise ValueError(f"gossip_every must be >= 1, got {self.gossip_every}")
        if self.wire not in LEVEL_WIRES:
            raise ValueError(f"unknown wire format {self.wire!r} (options: {LEVEL_WIRES})")


def parse_level_specs(spec: str) -> Tuple[LevelSpec, ...]:
    """Parse a comma-separated chain spec, innermost (model) level first,
    each level ``kind[:stride][:wire][:stale]`` (tokens after the kind in
    any order), e.g. ``"torus,ring_metropolis:2:q8,ring:4:q8:stale"``."""
    levels = []
    for part in spec.split(","):
        tokens = [t.strip() for t in part.strip().split(":") if t.strip()]
        if not tokens:
            raise ValueError(f"empty level in chain spec {spec!r}")
        kind, stride, wire, stale = tokens[0], 1, "fp32", False
        for tok in tokens[1:]:
            if tok.lstrip("-").isdigit():
                stride = int(tok)
            elif tok in LEVEL_WIRES:
                wire = tok
            elif tok == "stale":
                stale = True
            else:
                raise ValueError(
                    f"unknown token {tok!r} in level {part.strip()!r} of chain "
                    f"spec {spec!r} (expected an integer stride, one of "
                    f"{LEVEL_WIRES}, or 'stale')"
                )
        levels.append(LevelSpec(kind=kind, gossip_every=stride, wire=wire, stale=stale))
    return tuple(levels)


def chain_mixing_rate(*factors: np.ndarray) -> float:
    """sigma_2(A_{L-1} (x) ... (x) A_0) from the factors' spectra."""
    prods = np.ones(1)
    for a in factors:
        s = np.linalg.svd(np.asarray(a, np.float64), compute_uv=False)
        prods = np.outer(prods, s).ravel()
    prods = np.sort(prods)[::-1]
    return float(prods[1]) if prods.size > 1 else 0.0


@dataclasses.dataclass(frozen=True, eq=False)
class KroneckerChain:
    """An N-level combiner chain, levels innermost-first:

        A(t) = F_{L-1}(t) (x) ... (x) F_0(t),
        F_i(t) = combiners[i] if t % specs[i].gossip_every == 0 else I.

    Flat agent indexing is outermost-major (level L-1 varies slowest), the
    order of an (outer, ..., pod, model) grid.  Level 0 draws from the raw
    seed, level i >= 1 from `derive_seed(seed, i)`."""

    specs: Tuple[LevelSpec, ...]
    ns: Tuple[int, ...]
    combiners: Tuple[np.ndarray, ...]
    adjacencies: Tuple[Optional[np.ndarray], ...]
    p: float = 0.5
    seed: int = 0
    beta: float = 1.0 / 3.0

    def __post_init__(self):
        if not self.specs:
            raise ValueError("KroneckerChain needs at least one level")
        if not (len(self.specs) == len(self.ns) == len(self.combiners)
                == len(self.adjacencies)):
            raise ValueError("specs, ns, combiners, and adjacencies must have equal length")
        for i, (spec, n, a) in enumerate(zip(self.specs, self.ns, self.combiners)):
            a = np.asarray(a)
            if a.shape != (n, n):
                raise ValueError(f"level {i} combiner has shape {a.shape}, expected {(n, n)}")
            if not is_doubly_stochastic(a):
                raise ValueError(
                    f"level {i} (kind {spec.kind!r}) combiner is not doubly stochastic"
                )
            if spec.stale and i != len(self.specs) - 1:
                raise ValueError(
                    f"stale=True is only allowed on the outermost level (level "
                    f"{len(self.specs) - 1}), got it on level {i}"
                )

    @property
    def n_levels(self) -> int:
        return len(self.specs)

    @property
    def n_agents(self) -> int:
        """Total network size prod(ns)."""
        return int(np.prod(self.ns))

    @property
    def period(self) -> int:
        """LCM of the per-level gossip strides."""
        return math.lcm(*(s.gossip_every for s in self.specs))

    def kron(self) -> np.ndarray:
        """The dense all-hops-firing combiner A_{L-1} (x) ... (x) A_0."""
        acc = np.asarray(self.combiners[0], np.float64)
        for a in self.combiners[1:]:
            acc = np.kron(np.asarray(a, np.float64), acc)
        return acc

    def at(self, t: int) -> np.ndarray:
        """The dense combiner of iteration t (identity for a level whose
        stride does not fire)."""
        acc = None
        for spec, n, a in zip(self.specs, self.ns, self.combiners):
            f = np.asarray(a, np.float64) if int(t) % spec.gossip_every == 0 else np.eye(n)
            acc = f if acc is None else np.kron(f, acc)
        return acc

    def sequence(self) -> Tuple[np.ndarray, ...]:
        """One period of the per-iteration combiner sequence."""
        return tuple(self.at(t) for t in range(self.period))

    def window_combiner(self) -> np.ndarray:
        """The window product of `sequence()` (doubly stochastic)."""
        return _window_product(self.sequence())

    def mixing_rate(self) -> float:
        """sigma_2 of the all-hops-firing composition."""
        return chain_mixing_rate(*self.combiners)

    def effective_mixing_rate(self) -> float:
        """sigma_2(window product)^(1/period); `mixing_rate()` at period 1."""
        if self.period == 1:
            return self.mixing_rate()
        return windowed_mixing_rate(self.sequence())

    def as_callable(self, device=None) -> Callable:
        """``A_t(t) -> (n_agents, n_agents)`` float32 tensor over the dense
        stride-gated sequence (staleness is not modelled)."""
        return _stacked_callable(self.sequence(), device)

    def _with_model_level(self, n0: int, A0: np.ndarray, adj0) -> "KroneckerChain":
        return KroneckerChain(specs=self.specs, ns=(n0,) + self.ns[1:],
                              combiners=(A0,) + self.combiners[1:],
                              adjacencies=(adj0,) + self.adjacencies[1:],
                              p=self.p, seed=self.seed, beta=self.beta)

    def _model_level_at(self, n0: int, erdos_adj: Callable) -> "KroneckerChain":
        """The chain with level 0 re-derived at n0 agents (an erdos level
        from `erdos_adj(adjacency)`) and every outer level carried verbatim."""
        spec0 = self.specs[0]
        if spec0.kind == "erdos" and self.adjacencies[0] is not None:
            adj0 = erdos_adj(self.adjacencies[0])
            return self._with_model_level(n0, metropolis_weights(adj0), adj0)
        A0 = make_topology(spec0.kind, n0, p=self.p, seed=self.seed, beta=self.beta)
        return self._with_model_level(n0, A0, _adjacency_for(spec0.kind, n0))

    def grown(self, n_model_new: int) -> "KroneckerChain":
        """The chain for a larger innermost (model) level; outer levels are
        physical and carried verbatim.  An erdos model level grows by
        `erdos_renyi_grow` from stream (seed, 0, n_new), the flat static
        erdos coder's stream."""
        if n_model_new < self.ns[0]:
            raise ValueError(f"cannot grow model level from {self.ns[0]} agents down to "
                             f"{n_model_new}")
        return self._model_level_at(n_model_new, lambda adj: erdos_renyi_grow(
            adj, n_model_new, p=self.p, seed=derive_seed(self.seed, 0, n_model_new)))

    def shrunk(self, survivors: Sequence[int]) -> "KroneckerChain":
        """The chain for a surviving subset of the model level (drain);
        outer levels carried verbatim, an erdos model level restricted by
        `shrink_adjacency`."""
        survivors = _check_survivors(survivors, self.ns[0], "the model level")
        return self._model_level_at(len(survivors),
                                    lambda adj: shrink_adjacency(adj, survivors))


def make_kronecker_chain(
    specs: Sequence[LevelSpec],
    ns: Sequence[int],
    *,
    p: float = 0.5,
    seed: int = 0,
    beta: float = 1.0 / 3.0,
) -> KroneckerChain:
    """A validated N-level chain from specs and level sizes, both
    innermost-first (level 0 from the raw seed, level i from
    `derive_seed(seed, i)`)."""
    specs = tuple(specs)
    ns = tuple(int(n) for n in ns)
    if len(specs) != len(ns):
        raise ValueError(f"got {len(specs)} level specs but {len(ns)} level sizes")
    combiners, adjs = [], []
    for i, (spec, n) in enumerate(zip(specs, ns)):
        if spec.kind not in GRAPH_KINDS:
            raise KeyError(
                f"unknown topology kind {spec.kind!r} for chain level {i} "
                f"(options: {GRAPH_KINDS})"
            )
        level_seed = seed if i == 0 else derive_seed(seed, i)
        if spec.kind == "erdos":
            adj = erdos_renyi_adjacency(n, p=p, seed=level_seed)
            combiners.append(metropolis_weights(adj))
            adjs.append(adj)
        else:
            combiners.append(make_topology(spec.kind, n, p=p, seed=level_seed, beta=beta))
            adjs.append(_adjacency_for(spec.kind, n))
    return KroneckerChain(specs=specs, ns=ns, combiners=tuple(combiners),
                          adjacencies=tuple(adjs), p=p, seed=seed, beta=beta)


def kron_mixing_rate(A_pod: np.ndarray, A_model: np.ndarray) -> float:
    """sigma_2(A_pod (x) A_model) from the factors' spectra."""
    return chain_mixing_rate(A_model, A_pod)


@dataclasses.dataclass(frozen=True, eq=False)
class HierarchicalTopology:
    """A two-level combiner A = A_pod (x) A_model: agent (i, j) = pod i,
    model rank j at flat index i * n_model + j; the pod hop fires only at
    iterations t with t % gossip_every == 0.  Implemented by its two-level
    `chain()`."""

    pod_kind: str
    model_kind: str
    n_pods: int
    n_model: int
    A_pod: np.ndarray
    A_model: np.ndarray
    gossip_every: int = 1
    p: float = 0.5
    seed: int = 0
    beta: float = 1.0 / 3.0
    model_adjacency: Optional[np.ndarray] = None

    def __post_init__(self):
        for name, a, n in (("A_pod", self.A_pod, self.n_pods),
                           ("A_model", self.A_model, self.n_model)):
            a = np.asarray(a)
            if a.shape != (n, n):
                raise ValueError(f"{name} has shape {a.shape}, expected {(n, n)}")
            if not is_doubly_stochastic(a):
                raise ValueError(
                    f"{name} of hierarchical topology {self.model_kind!r}+"
                    f"{self.pod_kind!r} is not doubly stochastic"
                )
        if self.gossip_every < 1:
            raise ValueError(f"gossip_every must be >= 1, got {self.gossip_every}")

    def chain(self) -> KroneckerChain:
        """The equivalent two-level `KroneckerChain` (model level first)."""
        return KroneckerChain(
            specs=(LevelSpec(kind=self.model_kind),
                   LevelSpec(kind=self.pod_kind, gossip_every=self.gossip_every)),
            ns=(self.n_model, self.n_pods),
            combiners=(np.asarray(self.A_model, np.float64),
                       np.asarray(self.A_pod, np.float64)),
            adjacencies=(self.model_adjacency, None),
            p=self.p, seed=self.seed, beta=self.beta,
        )

    @property
    def n_agents(self) -> int:
        return self.n_pods * self.n_model

    @property
    def period(self) -> int:
        return self.gossip_every

    def kron(self) -> np.ndarray:
        return self.chain().kron()

    def local_only(self) -> np.ndarray:
        """The combiner of a pod-hop-free iteration: I (x) A_model."""
        return np.kron(np.eye(self.n_pods), np.asarray(self.A_model, np.float64))

    def at(self, t: int) -> np.ndarray:
        return self.chain().at(t)

    def sequence(self) -> Tuple[np.ndarray, ...]:
        return self.chain().sequence()

    def window_combiner(self) -> np.ndarray:
        return self.chain().window_combiner()

    def mixing_rate(self) -> float:
        return self.chain().mixing_rate()

    def effective_mixing_rate(self) -> float:
        return self.chain().effective_mixing_rate()

    def as_callable(self, device=None) -> Callable:
        return self.chain().as_callable(device)

    def grown(self, n_model_new: int) -> "HierarchicalTopology":
        """The hierarchy for a larger intra-pod agent count (A_pod carried
        verbatim), by `KroneckerChain.grown`."""
        g = self.chain().grown(n_model_new)
        return dataclasses.replace(self, n_model=n_model_new, A_model=g.combiners[0],
                                   model_adjacency=g.adjacencies[0])


def make_hierarchical_topology(
    pod_kind: str,
    model_kind: str,
    n_pods: int,
    n_model: int,
    *,
    p: float = 0.5,
    seed: int = 0,
    beta: float = 1.0 / 3.0,
    gossip_every: int = 1,
) -> HierarchicalTopology:
    """A validated two-level combiner A_pod (x) A_model (intra-pod from the
    raw seed, inter-pod from `derive_seed(seed, 1)`)."""
    for label, kind in (("pod_kind", pod_kind), ("model_kind", model_kind)):
        if kind not in GRAPH_KINDS:
            raise KeyError(f"unknown topology kind {kind!r} for {label} (options: {GRAPH_KINDS})")
    chain = make_kronecker_chain(
        (LevelSpec(kind=model_kind), LevelSpec(kind=pod_kind, gossip_every=int(gossip_every))),
        (n_model, n_pods), p=p, seed=seed, beta=beta,
    )
    return HierarchicalTopology(
        pod_kind=pod_kind, model_kind=model_kind, n_pods=n_pods, n_model=n_model,
        A_pod=chain.combiners[1], A_model=chain.combiners[0],
        gossip_every=int(gossip_every), p=p, seed=seed, beta=beta,
        model_adjacency=chain.adjacencies[0],
    )


def fixed_schedule(A: np.ndarray, kind: str = "fixed") -> TopologySchedule:
    """One-entry schedule around an explicit combiner `A` (`kind` is a label)."""
    A = np.asarray(A, np.float64)
    return TopologySchedule(spec=f"fixed:{kind}", n=A.shape[0], kinds=("explicit",),
                            combiners=(A,), adjacencies=(None,))


def make_topology_schedule(
    spec: str,
    n: int,
    *,
    p: float = 0.5,
    seed: int = 0,
    beta: float = 1.0 / 3.0,
    period: int = 2,
) -> TopologySchedule:
    """A `TopologySchedule` for `n` agents from a spec string:
    "fixed:<kind>" (period 1; "fixed:erdos" draws the static erdos graph
    from the raw seed), "alternating[:<k1>,<k2>,...]" (one iteration each;
    default ring_metropolis, torus; an erdos step i from
    `derive_seed(seed, i)`), or "erdos_resampled" (a fresh connected
    G(n, p) every step, `period` steps, step t from `derive_seed(seed, t)`)."""
    spec = (spec or "").strip()
    head, _, tail = spec.partition(":")
    if head == "fixed":
        kind = tail or "ring_metropolis"
        if kind not in GRAPH_KINDS:
            raise KeyError(f"unknown topology kind {kind!r} in spec {spec!r}")
        if kind == "erdos":
            adj = erdos_renyi_adjacency(n, p=p, seed=seed)
            return TopologySchedule(
                spec=f"fixed:{kind}", n=n, kinds=("erdos",),
                combiners=(metropolis_weights(adj),), adjacencies=(adj,),
                p=p, seed=seed, beta=beta,
            )
        return TopologySchedule(
            spec=f"fixed:{kind}", n=n, kinds=(kind,),
            combiners=(make_topology(kind, n, p=p, seed=seed, beta=beta),),
            adjacencies=(_adjacency_for(kind, n),), p=p, seed=seed, beta=beta,
        )
    if head == "alternating":
        kinds = tuple(k.strip() for k in tail.split(",") if k.strip()) or (
            "ring_metropolis", "torus",
        )
        combiners, adjs = [], []
        for i, kind in enumerate(kinds):
            if kind not in GRAPH_KINDS:
                raise KeyError(f"unknown topology kind {kind!r} in spec {spec!r}")
            if kind == "erdos":
                adj = erdos_renyi_adjacency(n, p=p, seed=derive_seed(seed, i))
                combiners.append(metropolis_weights(adj))
                adjs.append(adj)
            else:
                combiners.append(make_topology(kind, n, p=p, seed=seed, beta=beta))
                adjs.append(_adjacency_for(kind, n))
        return TopologySchedule(
            spec="alternating:" + ",".join(kinds), n=n, kinds=kinds,
            combiners=tuple(combiners), adjacencies=tuple(adjs), p=p, seed=seed, beta=beta,
        )
    if head == "erdos_resampled":
        if tail:
            raise KeyError(
                f"spec {spec!r} takes no ':' argument: the period of "
                f"'erdos_resampled' is the `period` argument "
                f"(DistConfig.schedule_period)"
            )
        if period < 1:
            raise ValueError(f"schedule period must be >= 1, got {period}")
        adjs = tuple(erdos_renyi_adjacency(n, p=p, seed=derive_seed(seed, t))
                     for t in range(period))
        return TopologySchedule(
            spec="erdos_resampled", n=n, kinds=("erdos",) * period,
            combiners=tuple(metropolis_weights(a) for a in adjs),
            adjacencies=adjs, p=p, seed=seed, beta=beta,
        )
    raise KeyError(
        f"unknown topology schedule spec {spec!r} (expected 'fixed:<kind>', "
        f"'alternating:<k1>,<k2>,...', or 'erdos_resampled')"
    )


# -- link failures: seeded Bernoulli link dropout over a schedule -----------


@dataclasses.dataclass(frozen=True, eq=False)
class LinkFailureSchedule(TopologySchedule):
    """A `TopologySchedule` whose steps are seeded link-failure
    realizations of a base schedule (`link_failure_schedule`): `fail_p`
    per-step, per-edge drop probability, `failure_seed` the base seed of
    the drop streams, `base` the un-failed schedule."""

    fail_p: float = 0.0
    failure_seed: int = 0
    base: Optional[TopologySchedule] = None

    def _rederived(self, resize: Callable, what: str) -> "LinkFailureSchedule":
        """The same failure streams over `resize(base)`."""
        if self.base is None:
            raise ValueError(f"cannot {what} a LinkFailureSchedule with no stored base "
                             f"schedule; build it via link_failure_schedule(base, ...)")
        return link_failure_schedule(resize(self.base), self.fail_p,
                                     failure_seed=self.failure_seed, steps=self.period)

    def grown(self, n_new: int) -> "LinkFailureSchedule":
        """Grow the base schedule, then re-apply the same failure streams."""
        return self._rederived(lambda base: base.grown(n_new), "grow")

    def shrunk(self, survivors: Sequence[int]) -> "LinkFailureSchedule":
        """Shrink the base schedule to the survivors, then re-apply the same
        failure streams."""
        return self._rederived(lambda base: base.shrunk(survivors), "shrink")


def link_failure_schedule(
    base,
    fail_p: float,
    *,
    failure_seed: int = 0,
    steps: Optional[int] = None,
) -> LinkFailureSchedule:
    """Wrap a `TopologySchedule` (or a `KroneckerChain`, flattened through
    its dense sequence) in seeded link failures: step t drops each
    undirected edge of the base step-t support with probability `fail_p`
    (stream `derive_seed(failure_seed, t)`) and Metropolis-renormalizes the
    survivors, so every A_t stays doubly stochastic.  `steps` (default: the
    base period) is the realized period."""
    if not 0.0 <= float(fail_p) < 1.0:
        raise ValueError(f"fail_p must be in [0, 1), got {fail_p}")
    if isinstance(base, KroneckerChain):
        chain = base
        base = TopologySchedule(
            spec="chain:" + ",".join(s.kind for s in chain.specs),
            n=chain.n_agents, kinds=("explicit",) * chain.period,
            combiners=chain.sequence(), adjacencies=(None,) * chain.period,
            p=chain.p, seed=chain.seed, beta=chain.beta,
        )
    if not isinstance(base, TopologySchedule):
        raise TypeError(
            f"link_failure_schedule needs a TopologySchedule or KroneckerChain "
            f"base, got {type(base).__name__}"
        )
    n = base.n
    steps = int(steps) if steps else base.period
    if steps < 1:
        raise ValueError(f"steps must be >= 1, got {steps}")
    kinds, combiners, adjs = [], [], []
    for t in range(steps):
        adj = np.asarray(base.at(t), np.float64) > 1e-12
        np.fill_diagonal(adj, False)
        adj = adj | adj.T
        rng = np.random.default_rng(derive_seed(failure_seed, t))
        drop = np.triu(rng.random((n, n)) < float(fail_p), 1)
        alive = adj & ~(drop | drop.T)
        kinds.append("linkfail")
        combiners.append(metropolis_weights(alive))
        adjs.append(alive)
    return LinkFailureSchedule(
        spec=f"linkfail:{float(fail_p):g}:{base.spec}", n=n,
        kinds=tuple(kinds), combiners=tuple(combiners), adjacencies=tuple(adjs),
        p=base.p, seed=base.seed, beta=base.beta,
        fail_p=float(fail_p), failure_seed=int(failure_seed), base=base,
    )
