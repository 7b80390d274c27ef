"""The port's single communication seam: gossip between the agents.

Port of the gossip part of src/repro/runtime/dist.py.  Every function goes
through a *wire* with two operations: `shift(x, d, dim, level)`, what each
agent receives when every agent i of a level sends to (i + d) % n, and
`agent_sum(x)`, the sum over every agent.  Two wires realize them:

  * `LOCAL` (`LocalWire`): all N agents on one device, the leading axis of
    a tensor, so a round is `torch.roll(x, d, dim)` and the sum `.sum(0)`;
  * `MeshWire(mesh, level_axes)`: one agent on each rank of a mesh
    (runtime/mesh.py), the agent axis of every tensor of size 1, so a
    round is a `Mesh.ppermute` over the level's mesh axis (`model` for
    level 0, `pod` for level 1, `pod<i>` beyond) and the sum a `psum` of
    the local term over the agent axes.  A round skips the pairs whose
    destination weight is zero, so a rank sends one message per
    out-neighbour: for ring, torus and complete combiners that is the JAX
    schedule's count (`wire_bytes_per_iter`), for an irregular graph
    (erdos) fewer than its rounds.

On either wire:

  * `gossip_psum` (the exact modes' all-reduce) sums over the agents;
  * `ring_shift` returns what each agent receives from its two ring
    neighbors: `left = shift(+1)` (agent k gets psi[k-1]) and
    `right = shift(-1)` (agent k gets psi[k+1]);
  * a `GraphSchedule` compiles a combiner A into the same edge-offset
    rounds as the JAX package: round d sends i -> (i+d) % n, so
    destination k receives psi[(k-d) % n] and scales it by its
    per-destination weight A[(k-d) % n, k] (`schedule_weights` gives the
    whole table on the local wire, this rank's entry on a mesh).
    `graph_accumulate` adds the rounds in the order of dist.py:388-403.

The JAX torus combiner's 4-link schedule is a mesh-wiring matter: a torus
A compiles through the offset decomposition (`torus_schedule`), which
realizes the same A, and reports the JAX schedule's round count as
`messages_per_iter` so the byte accounting agrees.  The int8 ("q8") wire:
the sender quantizes once per iteration, the rounds move the int8 payload
and its fp32 per-row scales, and each destination dequantizes what it
receives.  Push-sum's scalar weight rides the same rounds as its payload,
in fp32.  A Kronecker chain views the agent axis outermost-first as
(n_{L-1}, ..., n_0) (on a mesh every level holds one agent) and runs each
level's rounds along its own dim.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.topology import is_doubly_stochastic, is_row_stochastic, torus_dims

Tensor = torch.Tensor
Weights = Tuple[Tensor, Tuple[Tensor, ...]]  # (diag, one table per round)


class LocalWire:
    """Every agent on this device, the agent axis a dim of each tensor."""

    def held(self, ns: Sequence[int]) -> Tuple[int, ...]:
        """The agents of each level that one tensor holds: all of them."""
        return tuple(ns)

    def index(self, level: int = 0) -> Optional[int]:
        """This rank's agent index on `level` (None: the tensor holds every
        agent, so weight tables keep every entry)."""
        return None

    def shift(self, x: Tensor, d: int, dim: int = 0, level: int = 0,
              weights: Optional[Sequence[float]] = None) -> Tensor:
        """Every agent i of the level sends x to (i + d) % n; what each
        receives (agent k: x[k - d])."""
        return torch.roll(x, d, dims=dim)

    def agent_sum(self, x: Tensor) -> Tensor:
        """The sum over every agent of x (agents leading)."""
        return x.sum(dim=0)

    def agent_max(self, x: Tensor) -> Tensor:
        """The max over every agent of x (agents leading)."""
        return torch.max(x)


LOCAL = LocalWire()


class MeshWire(LocalWire):
    """One agent a rank: level i of the agent grid is the mesh axis
    `level_axes[i]` (innermost first); each tensor holds this rank's agent
    on a leading axis of size 1."""

    def __init__(self, mesh, level_axes: Sequence[str]):
        self.mesh = mesh
        self.level_axes = tuple(level_axes)

    def held(self, ns: Sequence[int]) -> Tuple[int, ...]:
        return (1,) * len(ns)

    def index(self, level: int = 0) -> Optional[int]:
        return self.mesh.index(self.level_axes[level])

    def shift(self, x: Tensor, d: int, dim: int = 0, level: int = 0,
              weights: Optional[Sequence[float]] = None) -> Tensor:
        """`Mesh.ppermute` with pairs i -> (i + d) % n on the level's axis,
        skipping destinations whose entry of `weights` is zero (they
        receive zeros, which their zero weight would have made of any
        message)."""
        axis = self.level_axes[level]
        n = self.mesh.size(axis)
        pairs = [(i, (i + d) % n) for i in range(n)
                 if weights is None or weights[(i + d) % n] != 0.0]
        return self.mesh.ppermute(x, axis, pairs)

    def _over_agents(self, x: Tensor, op) -> Tensor:
        for axis in reversed(self.level_axes):  # outermost first
            x = op(x, axis)
        return x

    def agent_sum(self, x: Tensor) -> Tensor:
        return self._over_agents(x.sum(dim=0), self.mesh.psum)

    def agent_max(self, x: Tensor) -> Tensor:
        return self._over_agents(torch.max(x), self.mesh.pmax)


@dataclasses.dataclass(frozen=True)
class GraphSchedule:
    """Static data-movement plan for nu_k = sum_l A[l, k] psi_l over n agents.

    `steps` holds one (offset d, per-destination weights w) entry per
    round: agent i sends to (i + d) % n and destination k scales what it
    receives by w[k] = A[(k - d) % n, k].  `diag` is the self-weight A[k, k].
    `messages` is the JAX schedule's round count, which differs from
    len(steps) only for a torus (its 4-link schedule)."""

    n: int
    diag: Tuple[float, ...]
    steps: Tuple[Tuple[int, Tuple[float, ...]], ...]
    messages: Optional[int] = None

    def reconstruct(self) -> np.ndarray:
        """Dense A this schedule realizes."""
        a = np.diag(np.asarray(self.diag, np.float64))
        for d, w in self.steps:
            for src in range(self.n):
                dst = (src + d) % self.n
                a[src, dst] += w[dst]
        return a

    @property
    def messages_per_iter(self) -> int:
        """Messages each agent sends per combine (the JAX schedule's rounds)."""
        return len(self.steps) if self.messages is None else self.messages


def _check_combiner(A: np.ndarray, row_stochastic: bool = False) -> np.ndarray:
    A = np.asarray(A, np.float64)
    if A.ndim != 2 or A.shape[0] != A.shape[1]:
        raise ValueError(f"combiner must be square, got shape {A.shape}")
    if row_stochastic:
        if not is_row_stochastic(A):
            raise ValueError(
                "push-sum combiner A must be row stochastic (nonnegative, rows "
                "summing to 1) -- see core/topology.make_topology's directed kinds"
            )
    elif not is_doubly_stochastic(A):
        raise ValueError(
            "combiner A must be doubly stochastic (nonnegative, rows and "
            "columns summing to 1) -- see core/topology.make_topology"
        )
    return A


def graph_schedule(A: np.ndarray, tol: float = 0.0, *,
                   row_stochastic: bool = False) -> GraphSchedule:
    """Compile a combiner into edge-offset rounds; offsets whose weight
    table is all zero are dropped, so a sparse graph costs its number of
    distinct edge offsets per iteration.  `row_stochastic=True` admits the
    push-sum modes' directed combiners (rows summing to 1 only)."""
    A = _check_combiner(A, row_stochastic=row_stochastic)
    n = A.shape[0]
    steps = []
    for d in range(1, n):
        w = np.array([A[(k - d) % n, k] for k in range(n)])
        if np.any(np.abs(w) > tol):
            steps.append((d, tuple(float(v) for v in w)))
    return GraphSchedule(
        n=n, diag=tuple(float(A[k, k]) for k in range(n)), steps=tuple(steps)
    )


def torus_schedule(rows: int, cols: int, A: np.ndarray) -> GraphSchedule:
    """A torus combiner's schedule: the offset rounds of `graph_schedule`
    (the same A), counting the JAX torus schedule's messages: one round per
    grid direction (row -/+1, column -/+1) that carries an edge not carried
    by an earlier one (dist.py:329-369)."""
    A = _check_combiner(A)
    n = rows * cols
    if A.shape[0] != n:
        raise ValueError(f"combiner is {A.shape[0]}x{A.shape[0]}, torus has {n} ranks")

    def idx(r: int, c: int) -> int:
        return (r % rows) * cols + (c % cols)

    seen: set = set()
    messages = 0
    for dr, dc in ((-1, 0), (1, 0), (0, -1), (0, 1)):
        carries = False
        for r in range(rows):
            for c in range(cols):
                dst, src = idx(r, c), idx(r + dr, c + dc)
                if src != dst and (src, dst) not in seen:
                    seen.add((src, dst))
                    carries = carries or A[src, dst] != 0.0
        messages += int(carries)
    return dataclasses.replace(graph_schedule(A), messages=messages)


def graph_schedule_sequence(
    As: Sequence[np.ndarray], kinds: Optional[Sequence[str]] = None
) -> Tuple[GraphSchedule, ...]:
    """One schedule per combiner of a time-varying sequence; torus steps
    through `torus_schedule`."""
    out = []
    for i, A in enumerate(As):
        if kinds is not None and kinds[i] == "torus":
            out.append(torus_schedule(*torus_dims(np.asarray(A).shape[0]), A))
        else:
            out.append(graph_schedule(A))
    return tuple(out)


def gossip_psum(x: Tensor, wire: LocalWire = LOCAL) -> Tensor:
    """Exact-mode gossip: the fully-connected combine, a sum over agents."""
    return wire.agent_sum(x)


def ring_shift(x: Tensor, wire: LocalWire = LOCAL) -> Tuple[Tensor, Tensor]:
    """(from_left, from_right): what each agent receives from its ring
    neighbors k-1 and k+1."""
    return wire.shift(x, 1), wire.shift(x, -1)


def schedule_weights(sched: GraphSchedule, dtype, device, dim: int = 0,
                     ndim: int = 3, index: Optional[int] = None) -> Weights:
    """The schedule's per-destination weight tables (diag, one per round),
    shaped to broadcast along `dim` of an `ndim`-dimensional tensor; with
    `index` (a mesh wire's `index(level)`) only that destination's entry.
    Tables are built in fp32, as in the JAX package, then cast to `dtype`;
    build them once per coder."""
    shape = [1] * ndim
    shape[dim] = sched.n if index is None else 1

    def col(w):
        w = w if index is None else (w[index],)
        return torch.tensor(w, dtype=torch.float32, device=device).to(dtype).reshape(shape)

    return col(sched.diag), tuple(col(w) for _, w in sched.steps)


def graph_shift(x: Tensor, sched: GraphSchedule, dim: int = 0, wire: LocalWire = LOCAL,
                level: int = 0) -> Tuple[Tensor, ...]:
    """Data movement only: one received message per round of the schedule."""
    return tuple(wire.shift(x, d, dim, level, w) for d, w in sched.steps)


def graph_accumulate(x_self: Tensor, received: Sequence[Tensor], weights: Weights) -> Tensor:
    """diag[k] * x_self + sum over rounds of w[k] * received[round], with
    `weights` from `schedule_weights`."""
    diag, steps = weights
    out = diag * x_self
    for w, r in zip(steps, received):
        out = out + w * r
    return out


def graph_combine(x: Tensor, sched: GraphSchedule, weights: Weights,
                  wire: LocalWire = LOCAL) -> Tensor:
    """Synchronous graph gossip nu_k = sum_l A[l, k] psi_l."""
    return graph_accumulate(x, graph_shift(x, sched, wire=wire), weights)


# -- the int8 wire format ----------------------------------------------------


def quantize_q8(x: Tensor) -> Tuple[Tensor, Tensor]:
    """Symmetric int8 quantization per row of the last axis: scale =
    max|x| / 127 + 1e-30, q = round(x / scale) (half to even) clipped to
    [-127, 127]; returns (q int8, scale in x's dtype)."""
    scale = x.abs().amax(dim=-1, keepdim=True) / 127.0 + 1e-30
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_q8(q: Tensor, scale: Tensor, dtype=None) -> Tensor:
    """Inverse of `quantize_q8` in `dtype` (default: the scale's)."""
    dtype = scale.dtype if dtype is None else dtype
    return q.to(dtype) * scale.to(dtype)


def quantize_with_feedback(x: Tensor, err: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """Quantize the outgoing message x + err once; returns (q, scale,
    new_err) with new_err = (x + err) - dequantize(q, scale), the error
    feedback every q8 mode keeps."""
    msg = x + err
    q, s = quantize_q8(msg)
    return q, s, msg - dequantize_q8(q, s)


def graph_shift_quantized(q: Tensor, s: Tensor, sched: GraphSchedule, dtype,
                          dim: int = 0, wire: LocalWire = LOCAL,
                          level: int = 0) -> Tuple[Tensor, ...]:
    """Each round moves the int8 payload and its scales; the destination
    dequantizes what it receives."""
    return tuple(
        dequantize_q8(wire.shift(q, d, dim, level, w), wire.shift(s, d, dim, level, w), dtype)
        for d, w in sched.steps
    )


def graph_combine_quantized(x_self: Tensor, q: Tensor, s: Tensor, sched: GraphSchedule,
                            weights: Weights, wire: LocalWire = LOCAL) -> Tensor:
    """`graph_combine` over the int8 wire: the self term uses the
    full-precision x_self, each round ships (q, s) from the sender's one
    quantization (error feedback stays with the caller)."""
    return graph_accumulate(
        x_self, graph_shift_quantized(q, s, sched, x_self.dtype, wire=wire), weights)


# -- push-sum (ratio consensus): a weight channel beside the payload -------


def push_graph_combine(x: Tensor, w: Tensor, sched: GraphSchedule,
                       weights: Weights, wire: LocalWire = LOCAL) -> Tuple[Tensor, Tensor]:
    """One push-sum round: ship (w * x, w) through the schedule; returns
    (v_new, w_new) = (A^T (w x), A^T w), w of shape (N, 1, 1).  The caller's
    estimate is v_new / w_new; on a doubly-stochastic A, w stays 1."""
    v = w.to(x.dtype) * x
    return graph_combine(v, sched, weights, wire), graph_combine(w, sched, weights, wire)


def push_graph_combine_quantized(v_self: Tensor, q: Tensor, s: Tensor, w: Tensor,
                                 sched: GraphSchedule, weights: Weights,
                                 wire: LocalWire = LOCAL) -> Tuple[Tensor, Tensor]:
    """`push_graph_combine` over the int8 wire: the caller quantizes
    v = w * psi once (with error feedback) and passes the full-precision v
    as `v_self`; the weight channel ships in fp32 on the same rounds."""
    return (graph_combine_quantized(v_self, q, s, sched, weights, wire),
            graph_combine(w, sched, weights, wire))


# -- the N-level Kronecker chain ---------------------------------------------


@dataclasses.dataclass(frozen=True)
class LevelPlan:
    """One compiled level of a `ChainSchedule`: its name `axis`, its
    `GraphSchedule`, its stride, wire format and staleness."""

    axis: str
    sched: GraphSchedule
    gossip_every: int = 1
    quantized: bool = False
    stale: bool = False

    @property
    def messages_per_iter(self) -> float:
        """Rounds per iteration on this level, averaged over the stride."""
        return self.sched.messages_per_iter / self.gossip_every


@dataclasses.dataclass(frozen=True)
class ChainSchedule:
    """Per-level plan of nu = (A_{L-1} (x) ... (x) A_0)^T psi, levels
    innermost-first; each level gated on its own stride."""

    levels: Tuple[LevelPlan, ...]

    @property
    def period(self) -> int:
        """LCM of the per-level strides."""
        return math.lcm(*(lvl.gossip_every for lvl in self.levels))

    @property
    def ns(self) -> Tuple[int, ...]:
        """Agents per level, innermost-first."""
        return tuple(lvl.sched.n for lvl in self.levels)

    def reconstruct(self) -> np.ndarray:
        """Dense all-hops-firing combiner this plan realizes."""
        acc = self.levels[0].sched.reconstruct()
        for lvl in self.levels[1:]:
            acc = np.kron(lvl.sched.reconstruct(), acc)
        return acc

    @property
    def messages_per_iter_per_level(self) -> Tuple[float, ...]:
        return tuple(lvl.messages_per_iter for lvl in self.levels)


def chain_schedule(chain, axes: Sequence[str]) -> ChainSchedule:
    """Compile a `core/topology.KroneckerChain` level by level (a torus
    level through `torus_schedule`); `axes` names each level."""
    axes = tuple(axes)
    if len(axes) != len(chain.specs):
        raise ValueError(f"chain has {len(chain.specs)} levels but got {len(axes)} axis names")
    levels = []
    for spec, A, axis in zip(chain.specs, chain.combiners, axes):
        if spec.kind == "torus":
            sched = torus_schedule(*torus_dims(np.asarray(A).shape[0]), A)
        else:
            sched = graph_schedule(A)
        levels.append(LevelPlan(axis=axis, sched=sched, gossip_every=spec.gossip_every,
                                quantized=(spec.wire == "q8"), stale=spec.stale))
    return ChainSchedule(levels=tuple(levels))


def wire_bytes_per_level(cs: ChainSchedule, b_loc: int, m: int) -> Tuple[float, ...]:
    """Stride-averaged wire bytes per iteration on each level for a
    (b_loc, m) per-agent block: one fp32 message is 4 b_loc m bytes, one q8
    message b_loc (m + 4)."""
    return tuple(
        lvl.messages_per_iter * (b_loc * (m + 4) if lvl.quantized else 4 * b_loc * m)
        for lvl in cs.levels
    )


def chain_weights(cs: ChainSchedule, dtype, device,
                  wire: LocalWire = LOCAL) -> Tuple[Weights, ...]:
    """Each level's weight tables, shaped for the (outer, n_i, inner, B, M)
    view `chain_combine` gossips level i in."""
    return tuple(schedule_weights(lvl.sched, dtype, device, dim=1, ndim=5, index=wire.index(i))
                 for i, lvl in enumerate(cs.levels))


def chain_state_init(x: Tensor, cs: ChainSchedule) -> Tuple:
    """Per-level (err, recv) state: the q8 error feedback (zeros, or () for
    an fp32 level) and, for a stale level, the previous firing's received
    messages (zeros, one per round: the first stale combine sees no
    neighbor, as graph_async's first step; () otherwise)."""
    return tuple(
        (torch.zeros_like(x) if lvl.quantized else (),
         tuple(torch.zeros_like(x) for _ in lvl.sched.steps) if lvl.stale else ())
        for lvl in cs.levels
    )


def _level_view(x: Tensor, ns: Tuple[int, ...], i: int) -> Tensor:
    """x (N, B, M), agents outermost-major, as (outer, n_i, inner, B, M);
    `ns` the agents of each level x holds (all ones on a mesh wire)."""
    return x.reshape(math.prod(ns[i + 1:]), ns[i], math.prod(ns[:i]), *x.shape[1:])


def _level_apply(v: Tensor, lvl: LevelPlan, i: int, ns, t: int, err, recv_prev,
                 weights: Weights, wire: LocalWire):
    """One level's gated hop on v (N, B, M): ship v's messages (fp32, or q8
    with error feedback), combine with them (or, stale, with the previous
    firing's), return (combined, new_err, new_recv).  An iteration with
    t % gossip_every != 0 passes everything through unchanged."""
    if t % lvl.gossip_every:
        return v, err, recv_prev
    u = _level_view(v, ns, i)
    if lvl.quantized:
        q, s, e_next = quantize_with_feedback(u, _level_view(err, ns, i))
        e_next = e_next.reshape(v.shape)
        recv = graph_shift_quantized(q, s, lvl.sched, u.dtype, dim=1, wire=wire, level=i)
    else:
        e_next = err
        recv = graph_shift(u, lvl.sched, dim=1, wire=wire, level=i)
    use = tuple(_level_view(r, ns, i) for r in recv_prev) if lvl.stale else recv
    out = graph_accumulate(u, use, weights).reshape(v.shape)
    return out, e_next, (tuple(r.reshape(v.shape) for r in recv) if lvl.stale else ())


def chain_combine(x: Tensor, cs: ChainSchedule, t: int, state: Tuple,
                  weights: Sequence[Weights], wire: LocalWire = LOCAL) -> Tuple[Tensor, Tuple]:
    """N-level gossip of x (N, B, M): every level innermost-first, each
    gated on its own stride by the iteration index t; returns (combined,
    new_state).  q8 levels update their error feedback only when they fire;
    stale levels combine with the previous firing's messages and keep this
    round's in the state."""
    ns = wire.held(cs.ns)
    out = x
    new_state = []
    for i, (lvl, (err, recv_prev), w) in enumerate(zip(cs.levels, state, weights)):
        out, err_next, recv_next = _level_apply(out, lvl, i, ns, t, err, recv_prev, w, wire)
        new_state.append((err_next, recv_next))
    return out, tuple(new_state)


@dataclasses.dataclass(frozen=True)
class HierSchedule:
    """The two-level view of a chain plan (hier modes): the intra-pod
    `model` schedule, the inter-pod `pod` schedule and the pod stride."""

    model: GraphSchedule
    pod: GraphSchedule
    gossip_every: int = 1

    def reconstruct(self) -> np.ndarray:
        """Dense A_pod (x) A_model of a pod-hop iteration."""
        return np.kron(self.pod.reconstruct(), self.model.reconstruct())

    @property
    def pod_messages_per_iter(self) -> float:
        """Inter-pod rounds per iteration, averaged over the pod stride."""
        return self.pod.messages_per_iter / self.gossip_every
