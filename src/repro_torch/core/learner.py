"""DictionaryLearner: the paper's Algorithm 1 (and its specializations 2-4).

Port of src/repro/core/learner.py.  A learner owns the task (residual f and
regularizer h, Table I), the agent topology (doubly stochastic combiner A),
the inference engine (diffusion / exact / fista) and the dictionary-step
hyperparameters.  `fit_batch` runs dual inference for a minibatch, then
per-agent primal recovery, then the local prox-projected dictionary step.

Plain PyTorch on `device` (the card unless the CPU is asked for), through the
reference engines of core/inference.py; the fused kernel is not used, as the
JAX learner does not use it.  Random draws come from an explicit
torch.Generator, so a state differs from the JAX package's for the same seed;
`convert.learner_state_from_numpy` gives both sides one state.  Every call
reads `self.cfg` afresh, so a caller may swap the config between epochs (the
denoising experiment decays mu_w that way).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core import topology as topo
from repro_torch.core.conjugates import dual_function, make_task, primal_objective
from repro_torch.core.dictionary import (
    blocks_from_full,
    dict_update,
    full_from_blocks,
    init_dictionary,
    make_prox,
)
from repro_torch.core.inference import (
    DiffusionConfig,
    diffusion_infer,
    exact_infer,
    fista_infer,
    recover_y,
    safe_diffusion_mu,
)
from repro_torch.device import DeviceLike, resolve_device

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class LearnerConfig:
    """Hyperparameters for distributed dictionary learning."""

    m: int  # data dimension
    k: int  # number of atoms (global)
    n_agents: int  # network size; k % n_agents == 0
    task: str = "sparse_svd"  # Table-I row
    gamma: float = 0.1
    delta: float = 0.1
    eta: float = 0.2  # Huber knee
    mu: float = 0.5  # inference step size
    inference_iters: int = 300
    inference_mode: str = "projection"  # projection | penalty
    engine: str = "diffusion"  # diffusion | exact | fista
    mu_w: float = 5e-2  # dictionary step size
    topology: str = "erdos"  # ring | ring_metropolis | torus | erdos | full
    topology_p: float = 0.5
    mu_scale: float = 1.0  # x safe step when mu <= 0 (smaller => lower bias)
    informed: str = "all"  # "all" | "one": the paper's two N_I setups
    h_w: str = "none"  # "none" | "l1" (bi-clustering)
    beta: float = 0.0  # l1 strength on W
    seed: int = 0

    def __post_init__(self):
        if self.k % self.n_agents:
            raise ValueError(f"k={self.k} must divide over n_agents={self.n_agents}")

    @property
    def atoms_per_agent(self) -> int:
        return self.k // self.n_agents


class LearnerState(NamedTuple):
    W_blocks: Tensor  # (N, M, Kb)
    step: int
    A: Tensor  # (N, N) combiner (constant, kept in state for checkpointing)
    informed: Tensor  # (N,) 0/1 mask


class StepMetrics(NamedTuple):
    primal_obj: Tensor
    dual_obj: Tensor
    residual_norm: Tensor
    sparsity: Tensor  # fraction of nonzero coefficients


def agent_products(nu: Tensor, W_blocks: Tensor) -> Tensor:
    """nu_k @ W_k for every agent k: nu (N, ..., M), W_blocks (N, M, Kb) ->
    (N, ..., Kb), as one batched matmul over the agents."""
    n, m, kb = W_blocks.shape
    return (nu.reshape(n, -1, m) @ W_blocks).reshape(nu.shape[:-1] + (kb,))


class DictionaryLearner:
    """Paper Algorithm 1 with pluggable engine/topology/task."""

    def __init__(self, cfg: LearnerConfig, device: DeviceLike = "cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.res, self.reg = make_task(cfg.task, cfg.gamma, cfg.delta, cfg.eta)

    # -- state ------------------------------------------------------------

    def init_state(self, generator: Optional[torch.Generator] = None) -> LearnerState:
        """Random unit-norm W from `generator` (one on this learner's device;
        default: seeded with cfg.seed), the cfg's combiner and informed mask."""
        cfg = self.cfg
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(cfg.seed)
        W = init_dictionary(generator, cfg.m, cfg.k, nonneg=self.reg.nonneg, device=self.device)
        A = torch.as_tensor(
            topo.make_topology(cfg.topology, cfg.n_agents, p=cfg.topology_p, seed=cfg.seed),
            dtype=torch.float32, device=self.device,
        )
        informed = torch.zeros((cfg.n_agents,), dtype=torch.float32, device=self.device)
        if cfg.informed == "all":
            informed.fill_(1.0)
        else:
            informed[0] = 1.0
        return LearnerState(W_blocks=blocks_from_full(W, cfg.n_agents), step=0, A=A,
                            informed=informed)

    def dictionary(self, state: LearnerState) -> Tensor:
        return full_from_blocks(state.W_blocks)

    def _input(self, x) -> Tensor:
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    # -- inference --------------------------------------------------------

    def _infer(self, state: LearnerState, x: Tensor, W: Optional[Tensor]) -> Tuple[Tensor, Tensor]:
        """(nu_agents (N, ..., M), y_agents (N, ..., Kb)); W is the full
        dictionary when the caller already holds it (else made here)."""
        cfg = self.cfg
        if cfg.engine == "diffusion":
            # cfg.mu <= 0 requests the curvature-adaptive safe step size.
            mu = (
                cfg.mu_scale * safe_diffusion_mu(self.res, self.reg, state.W_blocks)
                if cfg.mu <= 0
                else cfg.mu
            )
            nu, y, _ = diffusion_infer(
                self.res, self.reg, state.W_blocks, x, state.A, state.informed,
                DiffusionConfig(mu=cfg.mu, iters=cfg.inference_iters, mode=cfg.inference_mode),
                mu=mu,
            )
            return nu, y
        # Centralized engines: every agent shares the exact nu.
        if W is None:
            W = full_from_blocks(state.W_blocks)
        if cfg.engine == "exact":
            nu = exact_infer(self.res, self.reg, W, x, iters=cfg.inference_iters)
        elif cfg.engine == "fista":
            nu = fista_infer(self.res, self.reg, W, x, iters=cfg.inference_iters)
        else:
            raise KeyError(f"unknown engine {cfg.engine!r}")
        nu_agents = nu.expand((cfg.n_agents,) + tuple(nu.shape))
        return nu_agents, self.reg.ystar(agent_products(nu_agents, state.W_blocks))

    @torch.no_grad()
    def infer(self, state: LearnerState, x) -> Tuple[Tensor, Tensor]:
        """Return (nu_agents (N,...,M), y_agents (N,...,Kb)) for a batch x."""
        return self._infer(state, self._input(x), None)

    @torch.no_grad()
    def code(self, state: LearnerState, x) -> Tensor:
        """Full coefficient vector y (concatenated over agents) for batch x."""
        x = self._input(x)
        W = full_from_blocks(state.W_blocks)
        if self.cfg.engine == "fista":
            nu = fista_infer(self.res, self.reg, W, x, iters=self.cfg.inference_iters)
        else:
            nu = exact_infer(self.res, self.reg, W, x, iters=self.cfg.inference_iters)
        return recover_y(self.reg, W, nu)

    # -- learning ---------------------------------------------------------

    @torch.no_grad()
    def fit_batch(self, state: LearnerState, x) -> Tuple[LearnerState, StepMetrics]:
        """One minibatch step: infer -> recover -> local dictionary update.

        The metrics are taken on the dictionary from before the update, at
        agent 0's nu; one full copy of W serves the centralized engines'
        inference and the metrics."""
        cfg = self.cfg
        x = self._input(x)
        W_full = full_from_blocks(state.W_blocks)
        nu_agents, y_agents = self._infer(state, x, W_full)

        n, m, kb = state.W_blocks.shape
        prox = make_prox(cfg.h_w, cfg.mu_w, cfg.beta) if cfg.h_w != "none" else None
        W_new = dict_update(state.W_blocks, nu_agents.reshape(n, -1, m),
                            y_agents.reshape(n, -1, kb), cfg.mu_w,
                            nonneg=self.reg.nonneg, prox=prox)
        new_state = state._replace(W_blocks=W_new, step=state.step + 1)

        nu0 = nu_agents[0]
        # (N, ..., Kb) -> (..., N*Kb), matching full_from_blocks column order.
        y_full = y_agents.movedim(0, -2).reshape(tuple(x.shape[:-1]) + (-1,))
        metrics = StepMetrics(
            primal_obj=primal_objective(self.res, self.reg, W_full, y_full, x).mean(),
            dual_obj=dual_function(self.res, self.reg, W_full, nu0, x).mean(),
            residual_norm=torch.linalg.vector_norm(x - y_full @ W_full.T, dim=-1).mean(),
            sparsity=(y_full.abs() > 1e-8).float().mean(),
        )
        return new_state, metrics

    def fit(self, state: LearnerState, X, batch_size: int = 4):
        """Single-epoch streaming fit over rows of X (paper's online regime).

        The final partial minibatch is processed as a smaller batch rather
        than dropped: in the single-pass streaming regime every sample is
        presented exactly once, so silently truncating the tail loses data.
        """
        X = self._input(X)
        n_full = (X.shape[0] // batch_size) * batch_size
        metrics = None
        for xb in X[:n_full].reshape(-1, batch_size, X.shape[1]):
            state, metrics = self.fit_batch(state, xb)
        if n_full < X.shape[0]:
            state, metrics = self.fit_batch(state, X[n_full:])
        return state, metrics

    # -- dynamic network growth (novel-document experiment) ---------------

    def expanded(self, state: LearnerState, extra_agents: int, generator: torch.Generator):
        """Add agents/atoms (paper Sec. IV-C: +10 atoms per time step).

        Returns (new_learner, new_state) with old atom blocks preserved; the
        new agents' blocks come from `generator` (on this learner's device).
        """
        cfg = self.cfg
        new_cfg = dataclasses.replace(
            cfg, n_agents=cfg.n_agents + extra_agents,
            k=cfg.k + extra_agents * cfg.atoms_per_agent,
        )
        new_learner = DictionaryLearner(new_cfg, device=self.device)
        fresh = new_learner.init_state(generator)
        fresh.W_blocks[: cfg.n_agents] = state.W_blocks
        return new_learner, fresh._replace(step=state.step)
