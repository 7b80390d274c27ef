"""Conjugate-function machinery for the dual dictionary-learning problem.

Port of src/repro/core/conjugates.py: the residual losses f(u), the
regularizers h(y), their conjugates f*(nu) and h*(W^T nu), the closed-form
primal recovery and the dual-domain projections of Tables I-II and
Appendix A of Chen, Towfic, Sayed, "Dictionary Learning over Distributed
Models", IEEE TSP 2014.  Every function is elementwise or reduces over the
last axis, so it applies unchanged to (N, B, M) agent-batched tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

Tensor = torch.Tensor


def soft_threshold(x: Tensor, lam) -> Tensor:
    """Two-sided soft threshold  T_lam(x) = (|x| - lam)_+ sign(x)."""
    return torch.sign(x) * torch.clamp(torch.abs(x) - lam, min=0.0)


def soft_threshold_pos(x: Tensor, lam) -> Tensor:
    """One-sided soft threshold  T+_lam(x) = (x - lam)_+."""
    return torch.clamp(x - lam, min=0.0)


def _s_fn(x: Tensor, gamma, delta, thresh: Callable[[Tensor, float], Tensor]) -> Tensor:
    """S_{gamma/delta}(x) (Eq. 81 / 88): the value of h*(.) at delta*x."""
    t = thresh(x, gamma / delta)
    return (
        -gamma * torch.sum(torch.abs(t), dim=-1)
        - 0.5 * delta * torch.sum(t * t, dim=-1)
        + delta * torch.sum(x * t, dim=-1)
    )


@dataclasses.dataclass(frozen=True)
class Residual:
    """A residual loss f(u) with the dual-side quantities the algorithm
    needs (see the JAX `Residual` for the field meanings)."""

    name: str
    f: Callable[[Tensor], Tensor]
    fstar: Callable[[Tensor], Tensor]
    grad_fstar: Callable[[Tensor], Tensor]
    project_dual: Callable[[Tensor], Tensor]
    recover_z: Optional[Callable[[Tensor, Tensor], Tensor]]
    strongly_convex: bool
    bounded_dual: bool


def make_l2_residual() -> Residual:
    """f(u) = 0.5*||u||_2^2  =>  f* = 0.5*||nu||^2, V_f = R^M, z = x - nu."""
    return Residual(
        name="l2",
        f=lambda u: 0.5 * torch.sum(u * u, dim=-1),
        fstar=lambda nu: 0.5 * torch.sum(nu * nu, dim=-1),
        grad_fstar=lambda nu: nu,
        project_dual=lambda nu: nu,
        recover_z=lambda x, nu: x - nu,
        strongly_convex=True,
        bounded_dual=False,
    )


def make_huber_residual(eta: float = 0.2) -> Residual:
    """Huber loss with knee eta: f*(nu) = (eta/2)*||nu||^2 on
    V_f = {||nu||_inf <= 1} (Eq. 71-73, Table II)."""

    def f(u: Tensor) -> Tensor:
        a = torch.abs(u)
        quad = 0.5 * u * u / eta
        lin = a - 0.5 * eta
        return torch.sum(torch.where(a < eta, quad, lin), dim=-1)

    return Residual(
        name="huber",
        f=f,
        fstar=lambda nu: 0.5 * eta * torch.sum(nu * nu, dim=-1),
        grad_fstar=lambda nu: eta * nu,
        project_dual=lambda nu: torch.clamp(nu, -1.0, 1.0),
        recover_z=None,
        strongly_convex=False,
        bounded_dual=True,
    )


@dataclasses.dataclass(frozen=True)
class Regularizer:
    """Strongly convex coefficient regularizer h(y) and its dual-side
    pieces; `ystar(v)` is both the primal recovery (Eq. 37) and grad h*."""

    name: str
    gamma: float
    delta: float
    h: Callable[[Tensor], Tensor]
    hstar: Callable[[Tensor], Tensor]
    ystar: Callable[[Tensor], Tensor]
    nonneg: bool


def make_elastic_net(gamma: float, delta: float) -> Regularizer:
    """h(y) = gamma*||y||_1 + (delta/2)*||y||_2^2 (strongly convex)."""
    if delta <= 0:
        raise ValueError("elastic net needs delta > 0 for strong convexity")
    return Regularizer(
        name="elastic_net",
        gamma=gamma,
        delta=delta,
        h=lambda y: gamma * torch.sum(torch.abs(y), dim=-1)
        + 0.5 * delta * torch.sum(y * y, dim=-1),
        hstar=lambda v: _s_fn(v / delta, gamma, delta, soft_threshold),
        ystar=lambda v: soft_threshold(v, gamma) / delta,
        nonneg=False,
    )


def make_nonneg_elastic_net(gamma: float, delta: float) -> Regularizer:
    """h(y) = gamma*||y||_{1,+} + (delta/2)*||y||_2^2 (+inf for y < 0)."""
    if delta <= 0:
        raise ValueError("elastic net needs delta > 0 for strong convexity")

    def h(y: Tensor) -> Tensor:
        base = gamma * torch.sum(y, dim=-1) + 0.5 * delta * torch.sum(y * y, dim=-1)
        neg = torch.any(y < 0, dim=-1)
        return torch.where(neg, torch.full_like(base, float("inf")), base)

    return Regularizer(
        name="nonneg_elastic_net",
        gamma=gamma,
        delta=delta,
        h=h,
        hstar=lambda v: _s_fn(v / delta, gamma, delta, soft_threshold_pos),
        ystar=lambda v: soft_threshold_pos(v, gamma) / delta,
        nonneg=True,
    )


TASKS = {
    "sparse_svd": lambda gamma=0.1, delta=0.1, eta=0.2: (
        make_l2_residual(),
        make_elastic_net(gamma, delta),
    ),
    "bi_clustering": lambda gamma=0.1, delta=0.1, eta=0.2: (
        make_l2_residual(),
        make_elastic_net(gamma, delta),
    ),
    "nmf": lambda gamma=0.1, delta=0.1, eta=0.2: (
        make_l2_residual(),
        make_nonneg_elastic_net(gamma, delta),
    ),
    "nmf_huber": lambda gamma=0.1, delta=0.1, eta=0.2: (
        make_huber_residual(eta),
        make_nonneg_elastic_net(gamma, delta),
    ),
}


def make_task(name: str, gamma: float = 0.1, delta: float = 0.1, eta: float = 0.2):
    """Return (Residual, Regularizer) for a named Table-I task."""
    if name not in TASKS:
        raise KeyError(f"unknown task {name!r}; options: {sorted(TASKS)}")
    return TASKS[name](gamma=gamma, delta=delta, eta=eta)


def primal_objective(res: Residual, reg: Regularizer, W: Tensor, y: Tensor, x: Tensor) -> Tensor:
    """Q(W, y; x) = f(x - W y) + h(y)  (Eq. 12), batched over leading dims."""
    u = x - y @ W.T
    return res.f(u) + reg.h(y)


def dual_function(res: Residual, reg: Regularizer, W: Tensor, nu: Tensor, x: Tensor) -> Tensor:
    """g(nu; x) = -f*(nu) + nu^T x - sum_k h_k*(W_k^T nu)  (Eq. 26), on the
    full dictionary W (M, K)."""
    return -res.fstar(nu) + torch.sum(nu * x, dim=-1) - reg.hstar(nu @ W)
