"""Plain PyTorch version of the fused dict_dual_step kernel.

Port of src/repro/kernels/dict_dual_step/ref.py, batched over agents.  For
atom blocks W (N, M, Kb) and dual estimates nu (N, B, M) it computes, per
agent k,

    S_k = nu_k @ W_k                 (B, Kb)   correlate with the atoms
    Y_k = T_gamma(S_k) / delta       (B, Kb)   elastic-net primal recovery
    G_k = Y_k @ W_k^T                (B, M)    back-projection

in fp32, with T the two-sided soft threshold or, when `nonneg`, its
one-sided form.  G is taken from the fp32 Y; both are returned in nu's
dtype.  The wrapper (`ops.dict_dual_step`) runs this on CPU tensors, and
`chip_smoke.py` holds the CUDA kernel against it on the card.
"""

from __future__ import annotations

from typing import Tuple

import torch


def threshold(s: torch.Tensor, gamma: float, nonneg: bool) -> torch.Tensor:
    """T_gamma(s): (|s| - gamma)_+ sign(s), or (s - gamma)_+ when nonneg."""
    if nonneg:
        return torch.clamp(s - gamma, min=0.0)
    return torch.sign(s) * torch.clamp(torch.abs(s) - gamma, min=0.0)


def dict_dual_step_ref(
    W_blocks: torch.Tensor,  # (N, M, Kb)
    nu: torch.Tensor,  # (N, B, M); may be an expanded view (one nu for all)
    *,
    gamma: float,
    delta: float,
    nonneg: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (Y (N, B, Kb), G (N, B, M)) in nu's dtype."""
    W = W_blocks.float()
    s = torch.matmul(nu.float(), W)
    y = threshold(s, gamma, nonneg) / delta
    g = torch.matmul(y, W.transpose(-1, -2))
    return y.to(nu.dtype), g.to(nu.dtype)
