"""Dictionary update step (paper Eq. 40/51) and constraint-set projections.

Port of src/repro/core/dictionary.py.  The update is local per agent: with
the optimal dual nu and the local coefficients y_k, agent k takes

    W_k <- Pi_{W_k}( W_k + mu_w * nu^T y_k / B )

with the gradient averaged over the sample batch (paper footnote 4).
`init_dictionary` draws from an explicit torch.Generator, so its values
differ from the JAX package's; tests hand both sides one numpy W instead.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.device import DeviceLike, resolve_device

Tensor = torch.Tensor


def project_unit_cols(W: Tensor) -> Tensor:
    """Project each column (the M axis, second to last) onto the unit l2
    ball (Eq. 45); applies to (M, K) and (N, M, Kb) alike."""
    norms = torch.linalg.vector_norm(W, dim=-2, keepdim=True)
    return W / torch.clamp(norms, min=1.0)


def project_nonneg_unit_cols(W: Tensor) -> Tensor:
    """Clip negatives then project columns onto the unit l2 ball (Eq. 47)."""
    return project_unit_cols(torch.clamp(W, min=0.0))


def make_projection(nonneg: bool) -> Callable[[Tensor], Tensor]:
    """The constraint-set projection of the task: Eq. 47 if nonneg else Eq. 45."""
    return project_nonneg_unit_cols if nonneg else project_unit_cols


def dict_update(
    W_k: Tensor,  # (M, Kb) or (N, M, Kb)
    nu: Tensor,  # (B, M) or (N, B, M): this agent's optimal dual
    y_k: Tensor,  # (B, Kb) or (N, B, Kb): recovered local coefficients
    mu_w: float,
    *,
    nonneg: bool = False,
    prox: Optional[Callable[[Tensor], Tensor]] = None,
) -> Tensor:
    """One proximal-projected SGD step on the local atom block (Eq. 51)."""
    grad = nu.transpose(-1, -2) @ y_k / nu.shape[-2]  # (.., M, Kb)
    W_new = W_k + mu_w * grad
    if prox is not None:
        W_new = prox(W_new)
    return make_projection(nonneg)(W_new)


def init_dictionary(
    generator: torch.Generator,
    m: int,
    k: int,
    *,
    nonneg: bool = False,
    dtype=torch.float32,
    device: DeviceLike = "cuda",
) -> Tensor:
    """Random unit-norm (optionally nonneg) (m, k) dictionary, as in the
    paper, drawn on `device` from `generator` (which must live there)."""
    dev = resolve_device(device)
    W = torch.randn((m, k), generator=generator, dtype=dtype, device=dev)
    if nonneg:
        W.abs_()
    norms = torch.linalg.vector_norm(W, dim=0, keepdim=True)
    return W.div_(torch.clamp(norms, min=1e-12))


def blocks_from_full(W: Tensor, n_agents: int) -> Tensor:
    """Split (M, K) column-wise into contiguous (N, M, Kb); K must divide
    evenly.  Agent n owns columns [n*Kb, (n+1)*Kb)."""
    m, k = W.shape
    if k % n_agents:
        raise ValueError(f"K={k} not divisible by N={n_agents}")
    kb = k // n_agents
    return W.reshape(m, n_agents, kb).permute(1, 0, 2).contiguous()


def full_from_blocks(W_blocks: Tensor) -> Tensor:
    """Inverse of blocks_from_full: (N, M, Kb) -> (M, N*Kb)."""
    n, m, kb = W_blocks.shape
    return W_blocks.permute(1, 0, 2).reshape(m, n * kb)
