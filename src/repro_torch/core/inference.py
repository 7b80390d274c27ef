"""Dual-domain inference engines (sparse coding) for distributed dictionaries.

Port of src/repro/core/inference.py, the single-device reference the
production engine (core/distributed.py) is held against.  All three
engines solve the dual problem (paper Eq. 28)

    min_nu  f*(nu) - nu^T x + sum_k h_k*(W_k^T nu),   s.t. nu in V_f

1. `diffusion_infer`: N agents, each holding an atom block W_k, run
   adapt-then-combine diffusion (Eq. 31/35/36) under a doubly stochastic
   combiner A, static or a callable A_t of the iteration.  Agents are the
   leading axis of every tensor.  `push_sum_infer` is its ratio-consensus
   form over a row-stochastic (possibly directed) A.
2. `exact_infer`: centralized projected gradient descent on the dual.
3. `fista_infer`: Nesterov-accelerated dual descent.

This module is plain PyTorch: it does not go through the fused kernel.

Shapes: x is (..., M); W is (M, K); W_blocks is (N, M, Kb).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple, Union

import torch

from repro_torch.core.conjugates import Regularizer, Residual

Tensor = torch.Tensor


def agent_grad(
    res: Residual,
    reg: Regularizer,
    W_k: Tensor,  # (M, Kb), or (N, M, Kb) with nu (N, ..., M)
    nu: Tensor,  # (..., M)
    x: Tensor,  # (..., M)
    theta,  # 1 if the agent is informed else 0 (per agent: (N, 1, ..))
    n_agents: int,
    n_informed,
) -> Tensor:
    """grad_nu J_k(nu; x) = -theta*x/|N_I| + grad f*(nu)/N + W_k ystar(W_k^T nu)."""
    y_k = reg.ystar(nu @ W_k)
    return (
        -(theta / n_informed) * x
        + res.grad_fstar(nu) / n_agents
        + y_k @ W_k.transpose(-1, -2)
    )


def full_dual_grad(res: Residual, reg: Regularizer, W: Tensor, nu: Tensor, x: Tensor) -> Tensor:
    """Gradient of the summed dual cost on the full dictionary."""
    return res.grad_fstar(nu) - x + reg.ystar(nu @ W) @ W.T


def recover_y(reg: Regularizer, W: Tensor, nu: Tensor) -> Tensor:
    """Closed-form primal recovery y* = ystar(W^T nu) (Eq. 37, Table II)."""
    return reg.ystar(nu @ W)


@dataclasses.dataclass(frozen=True)
class DiffusionConfig:
    """Step size, iteration count and combine form of `diffusion_infer`."""

    mu: float = 0.5
    iters: int = 300
    mode: str = "projection"  # "projection" (Eq. 35) | "penalty" (Eq. 36)
    penalty_rho: float = 10.0


def diffusion_infer(
    res: Residual,
    reg: Regularizer,
    W_blocks: Tensor,  # (N, M, Kb)
    x: Tensor,  # (..., M)
    A: Union[Tensor, Callable[[int], Tensor]],  # (N, N), A[l, k] = a_{lk}; or t -> (N, N)
    informed: Tensor,  # (N,) 0/1 mask of N_I
    cfg: DiffusionConfig = DiffusionConfig(),
    nu0: Optional[Tensor] = None,  # (N, ..., M)
    record_every: int = 0,
    mu=None,  # overrides cfg.mu
) -> Tuple[Tensor, Tensor, Optional[Tensor]]:
    """Run ATC diffusion; returns (nu_agents (N,...,M), y_agents (N,...,Kb), traj).

    Every agent k carries its own nu_k; the combine mixes the intermediate
    psi_l over the neighborhood, nu_k = sum_l a_{lk} psi_l.  `A` is one
    doubly-stochastic (N, N) matrix or a callable ``A_t(t) -> (N, N)``
    giving the combiner of iteration t = 0, 1, ... (the time-varying
    regime; `core.topology.TopologySchedule.as_callable()` builds one).  With
    `record_every > 0` the nu trajectory is also returned every that many
    iterations; when `record_every` does not divide `cfg.iters` the
    remaining iterations still run, unrecorded, so nu always reflects the
    full budget."""
    n_agents = W_blocks.shape[0]
    batch_shape = tuple(x.shape[:-1])
    x = x.reshape(-1, x.shape[-1])  # agent-batched products need (B, M)
    if nu0 is not None:
        nu0 = nu0.reshape(n_agents, -1, x.shape[-1])
    dtype = x.dtype
    n_informed = torch.clamp(informed.sum(), min=1.0).to(dtype)
    mu = torch.as_tensor(cfg.mu if mu is None else mu, dtype=dtype, device=x.device)
    nu = torch.zeros((n_agents,) + tuple(x.shape), dtype=dtype, device=x.device) \
        if nu0 is None else nu0
    theta = informed.to(dtype).reshape(n_agents, 1, 1)
    A_fn = A if callable(A) else (lambda t, _A=A: _A)

    def step(nu: Tensor, t: int) -> Tensor:
        At = A_fn(t).T.to(dtype)
        g = agent_grad(res, reg, W_blocks, nu, x, theta, n_agents, n_informed)
        if cfg.mode == "penalty" and res.bounded_dual:
            zeta = nu - mu * g
            pen_grad = cfg.penalty_rho * (zeta - res.project_dual(zeta))
            return torch.tensordot(At, zeta - mu * pen_grad, dims=1)
        nu_next = torch.tensordot(At, nu - mu * g, dims=1)
        if res.bounded_dual:
            nu_next = res.project_dual(nu_next)
        return nu_next

    traj = None
    t = 0
    if record_every and record_every > 0:
        n_outer = cfg.iters // record_every
        frames = []
        for _ in range(n_outer):
            for _ in range(record_every):
                nu, t = step(nu, t), t + 1
            frames.append(nu)
        traj = torch.stack(frames) if frames else nu.new_zeros((0,) + tuple(nu.shape))
        for _ in range(cfg.iters - n_outer * record_every):
            nu, t = step(nu, t), t + 1
    else:
        for t in range(cfg.iters):
            nu = step(nu, t)

    y = reg.ystar(nu @ W_blocks)
    n = (n_agents,)
    if traj is not None:
        traj = traj.reshape(traj.shape[:1] + n + batch_shape + traj.shape[-1:])
    return nu.reshape(n + batch_shape + nu.shape[-1:]), \
        y.reshape(n + batch_shape + y.shape[-1:]), traj


def push_sum_infer(
    res: Residual,
    reg: Regularizer,
    W_blocks: Tensor,  # (N, M, Kb)
    x: Tensor,  # (..., M)
    A: Union[Tensor, Callable[[int], Tensor]],  # (N, N) row stochastic; or t -> (N, N)
    informed: Tensor,  # (N,) 0/1 mask of N_I
    cfg: DiffusionConfig = DiffusionConfig(),
    nu0: Optional[Tensor] = None,  # (N, ..., M)
    mu=None,  # overrides cfg.mu
) -> Tuple[Tensor, Tensor, Tensor]:
    """Push-sum (ratio-consensus) ATC diffusion over a row-stochastic A.

    Each agent carries (nu_k, w_k), w_k(0) = 1; per iteration
    psi_k = nu_k - mu grad J_k(nu_k), v_k = sum_l a_{lk} w_l psi_l,
    w_k <- sum_l a_{lk} w_l, nu_k <- project(v_k / w_k).  On a doubly
    stochastic A, w stays 1 and this is `diffusion_infer`.  Returns
    (nu_agents, y_agents, w_agents (N,))."""
    if cfg.mode == "penalty":
        raise ValueError(
            "push_sum_infer supports the projection combine only (the penalty "
            "form's extra gradient does not commute with the push-sum ratio)"
        )
    A_fn = A if callable(A) else (lambda t, _A=A: _A)
    n_agents = W_blocks.shape[0]
    batch_shape = tuple(x.shape[:-1])
    x = x.reshape(-1, x.shape[-1])
    dtype = x.dtype
    n_informed = torch.clamp(informed.sum(), min=1.0).to(dtype)
    mu = torch.as_tensor(cfg.mu if mu is None else mu, dtype=dtype, device=x.device)
    nu = torch.zeros((n_agents,) + tuple(x.shape), dtype=dtype, device=x.device) \
        if nu0 is None else nu0.reshape(n_agents, -1, x.shape[-1])
    w = torch.ones((n_agents, 1, 1), dtype=dtype, device=x.device)
    theta = informed.to(dtype).reshape(n_agents, 1, 1)
    for t in range(cfg.iters):
        g = agent_grad(res, reg, W_blocks, nu, x, theta, n_agents, n_informed)
        psi = nu - mu * g
        At = A_fn(t).T.to(dtype)
        v = torch.tensordot(At, w * psi, dims=1)
        w = torch.tensordot(At, w.reshape(n_agents), dims=1).reshape(n_agents, 1, 1)
        nu = v / w
        if res.bounded_dual:
            nu = res.project_dual(nu)
    y = reg.ystar(nu @ W_blocks)
    n = (n_agents,)
    return nu.reshape(n + batch_shape + nu.shape[-1:]), \
        y.reshape(n + batch_shape + y.shape[-1:]), w.reshape(n_agents)


def power_sigma2(W: Tensor, iters: int = 20) -> Tensor:
    """sigma_max(W)^2 by power iteration from the deterministic start
    v = 1/sqrt(K); batched over leading dims of W (..., M, K), returning
    (...).  The shared estimator behind every curvature bound."""
    k = W.shape[-1]
    v = torch.full(W.shape[:-2] + (k, 1), 1.0 / k ** 0.5, dtype=W.dtype, device=W.device)
    nv = None
    for _ in range(iters):
        u = W @ v
        v = W.transpose(-1, -2) @ u
        nv = torch.linalg.vector_norm(v, dim=(-2, -1), keepdim=True)
        v = v / (nv + 1e-30)
    return nv[..., 0, 0]


def estimate_dual_curvature(
    res: Residual, reg: Regularizer, W: Tensor, power_iters: int = 20
) -> Tuple[Tensor, Tensor]:
    """(L, m) bounds for the dual cost: m >= c_f, L <= c_f + sigma_max(W)^2/delta."""
    c_f = res.grad_fstar(torch.ones((1,), dtype=W.dtype, device=W.device))[0]
    sig2 = power_sigma2(W, power_iters)
    return c_f + sig2 / reg.delta, c_f


def safe_diffusion_mu(
    res: Residual,
    reg: Regularizer,
    W_blocks: Tensor,  # (N, M, Kb)
    safety: float = 0.9,
) -> Tensor:
    """Curvature-adaptive diffusion step: safety / max_k L_k with
    L_k <= c_f/N + sigma_max(W_k)^2/delta."""
    c_f = res.grad_fstar(torch.ones((1,), dtype=W_blocks.dtype, device=W_blocks.device))[0]
    n = W_blocks.shape[0]
    l_max = c_f / n + torch.max(power_sigma2(W_blocks)) / reg.delta
    return safety / l_max


def exact_infer(
    res: Residual,
    reg: Regularizer,
    W: Tensor,
    x: Tensor,
    mu: Optional[float] = None,
    iters: int = 500,
) -> Tensor:
    """Projected gradient descent on the full dual (fully-connected limit)."""
    L, _ = estimate_dual_curvature(res, reg, W)
    step_size = (1.0 / L) if mu is None else mu
    nu = torch.zeros_like(x)
    for _ in range(iters):
        nu = res.project_dual(nu - step_size * full_dual_grad(res, reg, W, nu, x))
    return nu


def fista_infer(
    res: Residual,
    reg: Regularizer,
    W: Tensor,
    x: Tensor,
    iters: int = 100,
) -> Tensor:
    """Nesterov-accelerated projected gradient on the dual, with the
    strongly-convex momentum beta = (sqrt(L)-sqrt(m))/(sqrt(L)+sqrt(m))."""
    L, m = estimate_dual_curvature(res, reg, W)
    beta = (torch.sqrt(L) - torch.sqrt(m)) / (torch.sqrt(L) + torch.sqrt(m))
    nu = torch.zeros_like(x)
    nu_prev = torch.zeros_like(x)
    for _ in range(iters):
        z = nu + beta * (nu - nu_prev)
        z = res.project_dual(z - (1.0 / L) * full_dual_grad(res, reg, W, z, x))
        nu, nu_prev = z, nu
    return nu


def snr_db(ref: Tensor, est: Tensor) -> Tensor:
    """10 log10(||ref||^2 / ||ref - est||^2), the paper's Fig.-4 metric."""
    num = torch.sum(ref * ref)
    den = torch.sum((ref - est) ** 2) + 1e-30
    return 10.0 * torch.log10(num / den + 1e-30)
