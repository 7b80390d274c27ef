"""Novel-document detection (paper Sec. IV-C, Algorithms 3-4).

Port of src/repro/core/detection.py.  A test document h is "novel" when the
optimal objective value of the inference problem is large; by strong
duality that value equals the dual optimum g(nu*; h), which every agent can
evaluate locally up to its own J_k term, and the network aggregates
-1/N sum_k J_k by a scalar diffusion consensus (Eqs. 63-66).  Both the
consensus and the exact aggregation are here; `roc_curve` and `auc` are the
reference's numpy, copied.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.core.conjugates import Regularizer, Residual
from repro_torch.core.learner import agent_products

Tensor = torch.Tensor


def local_cost(
    res: Residual,
    reg: Regularizer,
    W_k: Tensor,  # (M, Kb), or (N, M, Kb) with nu (N, ..., M)
    nu: Tensor,  # (..., M)
    h: Tensor,  # (..., M)
    theta,
    n_agents: int,
    n_informed,
) -> Tensor:
    """J_k(nu; h)  (paper Eq. 29) reduced over the feature axis."""
    nu_w = agent_products(nu, W_k) if W_k.dim() == 3 else nu @ W_k
    return (
        -(theta / n_informed) * torch.sum(nu * h, dim=-1)
        + res.fstar(nu) / n_agents
        + reg.hstar(nu_w)
    )


@torch.no_grad()
def consensus_score(
    res: Residual,
    reg: Regularizer,
    W_blocks: Tensor,  # (N, M, Kb)
    nu_agents: Tensor,  # (N, ..., M)
    h: Tensor,  # (..., M)
    A: Tensor,  # (N, N)
    mu_g: float = 0.5,
    iters: int = 200,
) -> Tensor:
    """Scalar diffusion (Eq. 65) converging to g = -1/N sum_k J_k(nu, h).

    Returns the per-agent scores (N, ...); all rows agree after convergence.
    """
    n = W_blocks.shape[0]
    J = local_cost(res, reg, W_blocks, nu_agents, h, 1.0, n, float(n))  # (N, ...)
    At = A.T.to(J.dtype)
    g = torch.zeros_like(J)
    for _ in range(iters):
        phi = g - mu_g * (J + g)
        g = torch.tensordot(At, phi, dims=1)
    return g


def exact_score(
    res: Residual,
    reg: Regularizer,
    W: Tensor,  # (M, K) full dictionary
    nu: Tensor,  # (..., M)
    h: Tensor,  # (..., M)
) -> Tensor:
    """-1/N aggregation computed exactly: -(f*(nu) - nu^T h + h*(W^T nu))/N.

    Up to the positive 1/N factor (absorbed into the threshold chi) this is
    the negated dual cost = g(nu; h); higher = worse fit = more novel.
    """
    val = res.fstar(nu) - torch.sum(nu * h, dim=-1) + reg.hstar(nu @ W)
    return -val


def roc_curve(scores: np.ndarray, labels: np.ndarray, n_thresh: int = 200
              ) -> Tuple[np.ndarray, np.ndarray]:
    """(pfa, pd) arrays swept over thresholds. labels: 1 = novel."""
    scores = np.asarray(scores, np.float64)
    labels = np.asarray(labels).astype(bool)
    lo, hi = scores.min(), scores.max()
    ts = np.linspace(hi + 1e-9, lo - 1e-9, n_thresh)
    pd, pfa = [], []
    npos = max(labels.sum(), 1)
    nneg = max((~labels).sum(), 1)
    for t in ts:
        det = scores > t
        pd.append((det & labels).sum() / npos)
        pfa.append((det & ~labels).sum() / nneg)
    return np.asarray(pfa), np.asarray(pd)


def auc(scores: np.ndarray, labels: np.ndarray) -> float:
    """Area under the ROC (Mann-Whitney form: exact, no threshold grid)."""
    scores = np.asarray(scores, np.float64)
    labels = np.asarray(labels).astype(bool)
    pos = scores[labels]
    neg = scores[~labels]
    if len(pos) == 0 or len(neg) == 0:
        return float("nan")
    greater = (pos[:, None] > neg[None, :]).sum()
    ties = (pos[:, None] == neg[None, :]).sum()
    return float((greater + 0.5 * ties) / (len(pos) * len(neg)))
