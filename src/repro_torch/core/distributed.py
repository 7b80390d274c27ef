"""Production engine for model-distributed dictionary learning, on one device.

Port of `DistributedSparseCoder` in src/repro/core/distributed.py for the
flat gossip modes `exact`, `exact_fista`, `ring` and `graph`.  The JAX
engine puts agent k on device k of a mesh axis; here all N agents live on
one device as the leading axis of every tensor: the dictionary is
(N, M, Kb), the per-agent duals (N, B, M), the codes (N, B, Kb).  Gossip
goes through the single seam `repro_torch.runtime.comm`.

Every iteration of every mode spends its time in one per-agent product,
S = nu W_k, Y = T_gamma(S)/delta, G = Y W_k^T.  It always goes through
`kernels.dict_dual_step.ops.dict_dual_step`: the hand-written CUDA kernel
on a CUDA tensor (launched or raising, never a fallback), its plain
version on a CPU tensor.  The exact modes share one nu between all agents
and pass it with agent stride 0.

Modes:
  exact        projected gradient on the summed dual: one sum over agents
               of the back-projections per iteration (fully-connected A).
  exact_fista  exact + strongly-convex Nesterov momentum, beta from c_f and
               L = 1/mu.
  ring         diffusion with the constant-weight [beta, 1-2beta, beta]
               ring combiner; the combine projects after mixing.
  graph        diffusion under any doubly-stochastic combiner of
               core/topology.make_topology, compiled to edge-offset rounds.

The other JAX modes are in MODE_REGISTRY with the ROADMAP slice that ports
them; configuring one raises NotImplementedError.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import topology as topo
from repro_torch.core.conjugates import Regularizer, Residual
from repro_torch.core.dictionary import blocks_from_full
from repro_torch.core.inference import power_sigma2
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.dict_dual_step import ops
from repro_torch.runtime import comm

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class ModeCaps:
    """One row of the mode registry.  `family` names the solver branch;
    `pending` is the ROADMAP slice that ports the mode ("" = ported)."""

    family: str
    pending: str = ""


_Q8_ASYNC = "6a (the q8 and async flat modes)"
_TV_PUSH = "6b (time-varying and push-sum modes)"
_CHAIN = "6c (the chain family)"

MODE_REGISTRY = {
    "exact": ModeCaps(family="exact"),
    "exact_fista": ModeCaps(family="exact"),
    "ring": ModeCaps(family="ring"),
    "ring_q8": ModeCaps(family="ring", pending=_Q8_ASYNC),
    "ring_async": ModeCaps(family="ring", pending=_Q8_ASYNC),
    "graph": ModeCaps(family="graph"),
    "graph_q8": ModeCaps(family="graph", pending=_Q8_ASYNC),
    "graph_async": ModeCaps(family="graph", pending=_Q8_ASYNC),
    "graph_tv": ModeCaps(family="tv", pending=_TV_PUSH),
    "graph_tv_q8": ModeCaps(family="tv", pending=_TV_PUSH),
    "push": ModeCaps(family="push", pending=_TV_PUSH),
    "push_q8": ModeCaps(family="push", pending=_TV_PUSH),
    "hier": ModeCaps(family="chain", pending=_CHAIN),
    "hier_q8": ModeCaps(family="chain", pending=_CHAIN),
    "chain": ModeCaps(family="chain", pending=_CHAIN),
}
MODES = tuple(MODE_REGISTRY)
PORTED_MODES = tuple(m for m, c in MODE_REGISTRY.items() if not c.pending)


@dataclasses.dataclass(frozen=True)
class DistConfig:
    """Configuration of the dual solver (the JAX `DistConfig` fields the
    flat modes read).

      mode           one of PORTED_MODES.
      iters          dual iterations per solve.
      mu             dual step size; <= 0 selects the curvature-adaptive
                     safe step (max over agents for the gossip modes, the
                     loose summed bound for the exact modes).
      beta           ring combiner weight, in [0, 1/2].
      topology       graph-mode combiner kind (core/topology.make_topology).
      topology_p     erdos edge probability.
      topology_seed  erdos graph seed.
      informed       "all" (every agent sees x) or "one" (only agent 0).
    """

    mode: str = "exact_fista"
    iters: int = 100
    mu: float = -1.0
    beta: float = 1.0 / 3.0
    topology: str = "ring_metropolis"
    topology_p: float = 0.5
    topology_seed: int = 0
    informed: str = "all"

    def __post_init__(self):
        caps = MODE_REGISTRY.get(self.mode)
        if caps is None:
            raise KeyError(f"unknown mode {self.mode!r}; options: {MODES}")
        if caps.pending:
            raise NotImplementedError(
                f"mode={self.mode!r} is not ported to PyTorch yet (ROADMAP "
                f"slice {caps.pending}); ported modes: {PORTED_MODES}"
            )
        if not 0.0 <= self.beta <= 0.5:
            raise ValueError(
                f"DistConfig.beta={self.beta} outside the admissible range "
                f"[0, 1/2]: the ring combiner [beta, 1-2*beta, beta] needs "
                f"beta <= 1/2 to keep all weights nonnegative"
            )
        if self.informed not in ("all", "one"):
            raise ValueError(f"informed must be 'all' or 'one', got {self.informed!r}")
        if self.iters < 0:
            raise ValueError(f"iters must be >= 0, got {self.iters}")
        if self.topology not in topo.GRAPH_KINDS:
            raise ValueError(
                f"unknown topology {self.topology!r}; options: {topo.GRAPH_KINDS}"
            )


def _c_f(res: Residual, like: Tensor) -> Tensor:
    """Curvature of f*: grad f*(1) (1 for l2, eta for Huber)."""
    return res.grad_fstar(torch.ones((1,), dtype=like.dtype, device=like.device))[0]


def _safe_mu_local(res: Residual, reg: Regularizer, W: Tensor) -> Tensor:
    """Globally safe diffusion step 0.9 / (c_f/N + max_k sigma_max(W_k)^2/delta):
    every agent steps with the one mu that is safe for the worst block."""
    sig2_max = torch.max(power_sigma2(W))
    return 0.9 / (_c_f(res, W) / W.shape[0] + sig2_max / reg.delta)


def _safe_mu_exact(res: Residual, reg: Regularizer, W: Tensor) -> Tensor:
    """1/L for the summed dual with the loose bound
    sigma_max(W)^2 <= sum_k sigma_max(W_k)^2 (as the JAX engine: not
    estimate_dual_curvature)."""
    sig2_sum = torch.sum(power_sigma2(W))
    return 1.0 / (_c_f(res, W) + sig2_sum / reg.delta)


class DistributedSparseCoder:
    """Dual-domain sparse coder over an atom-sharded dictionary, N agents
    on one device.

    Usage:
        coder = DistributedSparseCoder(n_agents, res, reg, cfg, device="cuda")
        W, x = coder.shard(W_full, x)         # (N, M, Kb) blocks, (B, M)
        nu, y = coder.solve(W, x)
        W2 = coder.fit_batch(W, x, mu_w)      # one dictionary step
    """

    def __init__(
        self,
        n_agents: int,
        res: Residual,
        reg: Regularizer,
        cfg: DistConfig,
        device: DeviceLike = "cuda",
    ):
        if n_agents < 1:
            raise ValueError(f"n_agents must be >= 1, got {n_agents}")
        self.n_agents = int(n_agents)
        self.res = res
        self.reg = reg
        self.cfg = cfg
        self.device = resolve_device(device)
        self._caps = MODE_REGISTRY[cfg.mode]
        n = self.n_agents
        self._A: Optional[np.ndarray] = None
        self._gsched: Optional[comm.GraphSchedule] = None
        self._gweights = None
        if self._caps.family == "graph":
            self._A = topo.make_topology(
                cfg.topology, n, p=cfg.topology_p, seed=cfg.topology_seed, beta=cfg.beta
            )
            self._gsched = comm.graph_schedule(self._A)
            self._gweights = comm.schedule_weights(self._gsched, torch.float32, self.device)
        # Informed-agent weighting (theta, |N_I|) of paper Eq. 29.
        if cfg.informed == "all":
            theta = torch.ones(n, dtype=torch.float32)
            n_inf = float(n)
        else:  # only agent 0 sees x
            theta = (torch.arange(n) == 0).to(torch.float32)
            n_inf = 1.0
        self._theta = theta.reshape(n, 1, 1).to(self.device)
        self._n_inf = torch.tensor(n_inf, dtype=torch.float32, device=self.device)

    # -- the per-agent hot loop --------------------------------------------

    def _code_and_back(self, W: Tensor, nu: Tensor) -> Tuple[Tensor, Tensor]:
        """y = ystar(W_k^T nu), back = y W_k^T for every agent, fused."""
        reg = self.reg
        return ops.dict_dual_step(
            W, nu, gamma=reg.gamma, delta=reg.delta, nonneg=reg.nonneg
        )

    def _local_grad(self, W: Tensor, x: Tensor, nu: Tensor) -> Tensor:
        """grad J_k for every agent (mirrors core/inference.agent_grad)."""
        _, back = self._code_and_back(W, nu)
        return (
            -(self._theta / self._n_inf) * x
            + self.res.grad_fstar(nu) / self.n_agents
            + back
        )

    def _mu_for(self, W: Tensor) -> Tensor:
        """THE step-size rule, shared by the solver and `adaptive_mu`.  The
        adaptive step re-runs 20 power iterations per block on every call."""
        if self.cfg.mu > 0:
            return torch.tensor(self.cfg.mu, dtype=W.dtype, device=W.device)
        if self._caps.family == "exact":
            return _safe_mu_exact(self.res, self.reg, W)
        return _safe_mu_local(self.res, self.reg, W)

    def _solve_body(self, W: Tensor, x: Tensor) -> Tuple[Tensor, Tensor]:
        """cfg.iters iterations from nu = 0; returns the per-agent
        (nu (N, B, M), y (N, B, Kb))."""
        res, cfg = self.res, self.cfg
        n = self.n_agents
        mu = self._mu_for(W)

        if self._caps.family == "exact":
            def total_grad(nu):  # nu (B, M), shared by every agent
                _, back = self._code_and_back(W, nu)
                return res.grad_fstar(nu) - x + comm.gossip_psum(back)

            nu = torch.zeros_like(x)
            if cfg.mode == "exact":
                for _ in range(cfg.iters):
                    nu = res.project_dual(nu - mu * total_grad(nu))
            else:  # exact_fista: kappa from the same bound, m >= c_f
                c_f = _c_f(res, W)
                L = 1.0 / mu
                beta = (torch.sqrt(L) - torch.sqrt(c_f)) / (torch.sqrt(L) + torch.sqrt(c_f))
                nu_prev = nu
                for _ in range(cfg.iters):
                    z = nu + beta * (nu - nu_prev)
                    z = res.project_dual(z - mu * total_grad(z))
                    nu, nu_prev = z, nu
            y, _ = self._code_and_back(W, nu)
            return nu.expand(n, *nu.shape), y

        nu = torch.zeros((n,) + tuple(x.shape), dtype=x.dtype, device=x.device)
        if self._caps.family == "ring":
            beta = torch.tensor(cfg.beta, dtype=x.dtype, device=x.device)
            for _ in range(cfg.iters):
                psi = nu - mu * self._local_grad(W, x, nu)
                left, right = comm.ring_shift(psi)
                nu = res.project_dual(
                    (1.0 - 2.0 * beta) * psi + beta * left + beta * right
                )
        else:  # graph
            for _ in range(cfg.iters):
                psi = nu - mu * self._local_grad(W, x, nu)
                nu = res.project_dual(comm.graph_combine(psi, self._gsched, self._gweights))
        y, _ = self._code_and_back(W, nu)
        return nu, y

    # -- public API ----------------------------------------------------------

    def _check_blocks(self, W: Tensor) -> Tensor:
        if W.dim() != 3 or W.shape[0] != self.n_agents or W.device != self.device:
            raise ValueError(
                f"W must be the ({self.n_agents}, M, Kb) blocks on {self.device} "
                f"(see shard/snapshot), got {tuple(W.shape)} on {W.device}"
            )
        return W

    def _check(self, W: Tensor, x) -> Tuple[Tensor, Tensor]:
        W = self._check_blocks(W)
        x = torch.as_tensor(x, dtype=W.dtype, device=self.device)
        if x.dim() != 2 or x.shape[1] != W.shape[1]:
            raise ValueError(f"x must be (B, {W.shape[1]}), got {tuple(x.shape)}")
        return W, x

    @torch.no_grad()
    def solve(self, W: Tensor, x) -> Tuple[Tensor, Tensor]:
        """Dual inference on blocks W (N, M, Kb) for a batch x (B, M).

        Returns (nu (B, M), y (B, K)): nu is agent 0's estimate (the gossip
        modes reach approximate consensus, so agents differ slightly; the
        exact modes share one nu), and y is the per-agent blocks laid side
        by side, agent-major, in the column order of blocks_from_full."""
        W, x = self._check(W, x)
        nu, y = self._solve_body(W, x)
        return nu[0], y.permute(1, 0, 2).reshape(x.shape[0], -1)

    @torch.no_grad()
    def solve_per_agent(self, W: Tensor, x) -> Tuple[Tensor, Tensor]:
        """Dual inference with per-agent outputs: nu (N, B, M) and
        y (N, B, Kb), the reference engine's layout."""
        W, x = self._check(W, x)
        nu, y = self._solve_body(W, x)
        return nu.contiguous(), y

    @torch.no_grad()
    def fit_batch(self, W: Tensor, x, mu_w: float) -> Tensor:
        """One dictionary-learning step (Alg. 1, Eq. 51); returns a NEW
        (N, M, Kb) buffer and never writes W.  Each agent updates its block
        with its own nu_k: W_k + mu_w * nu_k^T y_k / B, clamped at 0 for a
        nonneg task, then each column divided by max(||column||, 1)."""
        W, x = self._check(W, x)
        nu, y = self._solve_body(W, x)
        W_new = torch.bmm(nu.transpose(1, 2), y)  # (N, M, Kb), fresh buffer
        W_new.mul_(mu_w).div_(x.shape[0]).add_(W)
        if self.reg.nonneg:
            W_new.clamp_(min=0.0)
        norms = torch.linalg.vector_norm(W_new, dim=1, keepdim=True)
        return W_new.div_(norms.clamp_(min=1.0))

    @torch.no_grad()
    def adaptive_mu(self, W: Tensor) -> Tensor:
        """The step size every agent's solve uses, as (N,); all equal."""
        return self._mu_for(self._check_blocks(W)).expand(self.n_agents).clone()

    def snapshot(self, W) -> Tensor:
        """The (N, M, Kb) blocks of W on this coder's device: W is either
        (M, K) (split with blocks_from_full) or already (N, M, Kb).  Does not
        copy blocks that are already contiguous there; `fit_batch` never
        writes its input, so readers may share the buffer."""
        W = torch.as_tensor(W)
        if W.dim() == 2:
            W = blocks_from_full(W.to(self.device), self.n_agents)
        if W.dim() != 3 or W.shape[0] != self.n_agents:
            raise ValueError(f"cannot place W {tuple(W.shape)} on {self.n_agents} agents")
        return W.to(self.device).contiguous()

    def shard(self, W, x) -> Tuple[Tensor, Tensor]:
        """(blocks (N, M, Kb), x (B, M)) on this coder's device."""
        W = self.snapshot(W)
        return W, torch.as_tensor(x, dtype=W.dtype, device=self.device)

    def combiner(self) -> np.ndarray:
        """The doubly-stochastic A this mode realizes (A[l, k] = a_{lk}):
        the graph combiner, the constant-weight ring, or 11^T/N."""
        if self._A is not None:
            return np.array(self._A)
        if self._caps.family == "exact":
            return topo.uniform_weights(self.n_agents)
        return topo.ring_weights(self.n_agents, self.cfg.beta)

    def combiner_info(self) -> Dict:
        """Topology label and mixing rate for stats, with the JAX engine's
        keys (static flat modes: no schedule, one level)."""
        family = self._caps.family
        label = self.cfg.topology if family == "graph" else (
            "ring" if family == "ring" else "full"
        )
        return {
            "topology": label,
            "mixing_rate": topo.mixing_rate(self.combiner()),
            "schedule": None,
            "schedule_period": 1,
            "pod_topology": None,
            "pod_gossip_every": 1,
            "levels": [{
                "kind": label,
                "axis": "model",
                "n": self.n_agents,
                "gossip_every": 1,
                "wire": "fp32",
                "stale": False,
            }],
        }
