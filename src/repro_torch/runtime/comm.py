"""The port's single communication seam: gossip between the agents.

Port of the static part of src/repro/runtime/dist.py.  On one device all N
agents are the leading axis of a tensor, so a collective round is a shift
of that axis:

  * `gossip_psum` (the exact modes' all-reduce) sums over the agent axis;
  * `ring_shift` returns what each agent receives from its two ring
    neighbors: `left = roll(+1)` (agent k gets psi[k-1]) and
    `right = roll(-1)` (agent k gets psi[k+1]);
  * a `GraphSchedule` compiles a doubly-stochastic combiner A into the
    same edge-offset rounds as the JAX package: round d sends i -> (i+d) % n,
    so destination k receives psi[(k-d) % n], which is `roll(psi, d, 0)`,
    and scales it by its per-destination weight A[(k-d) % n, k].
    `graph_accumulate` adds the rounds in the order of dist.py:388-403.

The JAX torus combiner's 4-link schedule is a mesh-wiring matter with no
meaning on one device: a torus A compiles through `graph_schedule`, which
realizes the same A.  A torch.distributed realization (one process per
agent) can slot in behind these functions later.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.topology import is_doubly_stochastic

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class GraphSchedule:
    """Static data-movement plan for nu_k = sum_l A[l, k] psi_l over n agents.

    `steps` holds one (offset d, per-destination weights w) entry per
    round: agent i sends to (i + d) % n and destination k scales what it
    receives by w[k] = A[(k - d) % n, k].  `diag` is the self-weight A[k, k].
    """

    n: int
    diag: Tuple[float, ...]
    steps: Tuple[Tuple[int, Tuple[float, ...]], ...]

    def reconstruct(self) -> np.ndarray:
        """Dense A this schedule realizes."""
        a = np.diag(np.asarray(self.diag, np.float64))
        for d, w in self.steps:
            for src in range(self.n):
                dst = (src + d) % self.n
                a[src, dst] += w[dst]
        return a


def _check_combiner(A: np.ndarray) -> np.ndarray:
    A = np.asarray(A, np.float64)
    if A.ndim != 2 or A.shape[0] != A.shape[1]:
        raise ValueError(f"combiner must be square, got shape {A.shape}")
    if not is_doubly_stochastic(A):
        raise ValueError(
            "combiner A must be doubly stochastic (nonnegative, rows and "
            "columns summing to 1) -- see core/topology.make_topology"
        )
    return A


def graph_schedule(A: np.ndarray, tol: float = 0.0) -> GraphSchedule:
    """Compile a doubly-stochastic combiner into edge-offset rounds; offsets
    whose weight table is all zero are dropped, so a sparse graph costs its
    number of distinct edge offsets per iteration."""
    A = _check_combiner(A)
    n = A.shape[0]
    steps = []
    for d in range(1, n):
        w = np.array([A[(k - d) % n, k] for k in range(n)])
        if np.any(np.abs(w) > tol):
            steps.append((d, tuple(float(v) for v in w)))
    return GraphSchedule(
        n=n, diag=tuple(float(A[k, k]) for k in range(n)), steps=tuple(steps)
    )


def gossip_psum(x: Tensor) -> Tensor:
    """Exact-mode gossip: the fully-connected combine, a sum over agents."""
    return x.sum(dim=0)


def ring_shift(x: Tensor) -> Tuple[Tensor, Tensor]:
    """(from_left, from_right): what each agent receives from its ring
    neighbors k-1 and k+1."""
    return torch.roll(x, 1, dims=0), torch.roll(x, -1, dims=0)


def schedule_weights(sched: GraphSchedule, dtype, device) -> Tuple[Tensor, Tuple[Tensor, ...]]:
    """The schedule's per-destination weight tables as (n, 1, 1) tensors:
    (diag, one table per round).  Tables are built in fp32, as in the JAX
    package, then cast to `dtype`; build them once per coder."""
    def col(w):
        return torch.tensor(w, dtype=torch.float32, device=device).to(dtype).reshape(-1, 1, 1)

    return col(sched.diag), tuple(col(w) for _, w in sched.steps)


def graph_shift(x: Tensor, sched: GraphSchedule) -> Tuple[Tensor, ...]:
    """Data movement only: one received message per round of the schedule."""
    return tuple(torch.roll(x, d, dims=0) for d, _ in sched.steps)


def graph_accumulate(
    x_self: Tensor, received: Sequence[Tensor], weights: Tuple[Tensor, Tuple[Tensor, ...]]
) -> Tensor:
    """diag[k] * x_self + sum over rounds of w[k] * received[round], with
    `weights` from `schedule_weights`."""
    diag, steps = weights
    out = diag * x_self
    for w, r in zip(steps, received):
        out = out + w * r
    return out


def graph_combine(
    x: Tensor, sched: GraphSchedule, weights: Tuple[Tensor, Tuple[Tensor, ...]]
) -> Tensor:
    """Synchronous graph gossip nu_k = sum_l A[l, k] psi_l."""
    return graph_accumulate(x, graph_shift(x, sched), weights)
