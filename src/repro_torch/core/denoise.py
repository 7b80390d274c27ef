"""Image denoising via distributed dictionary learning (paper Sec. IV-B).

Port of src/repro/core/denoise.py.  Pipeline: extract overlapping patches ->
remove per-patch DC -> dual inference on the learned dictionary -> z = x - nu
reconstruction -> overlap-add with uniform averaging -> PSNR.  Matches the
paper's 10x10-patch, M=100 setup; works with any learner whose task has a
recoverable z (l2 residual).  Runs where the learner lives (`learner.device`).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.inference import fista_infer

Tensor = torch.Tensor


def extract_patches(img: Tensor, patch: int = 10, stride: int = 1) -> Tuple[Tensor, Tuple[int, int]]:
    """All overlapping patch x patch patches, vectorized column-major like the
    paper (vertically stacked columns).  Returns (n_patches, patch*patch)
    and the (rows, cols) grid of patch positions."""
    win = img.unfold(0, patch, stride).unfold(1, patch, stride)  # (ph, pw, row, col)
    ph, pw = win.shape[:2]
    return win.transpose(-1, -2).reshape(ph * pw, patch * patch), (ph, pw)


def reconstruct_from_patches(
    patches: Tensor, grid: Tuple[int, int], shape: Tuple[int, int], patch: int = 10, stride: int = 1
) -> Tensor:
    """Overlap-add with per-pixel averaging (inverse of extract_patches).
    F.fold sums the overlaps in another order than the reference's scan, so
    the two agree to fp32 rounding, not bit for bit."""
    n = grid[0] * grid[1]
    # column-major within a patch -> the row-major order fold expects
    cols = patches.reshape(n, patch, patch).transpose(1, 2).reshape(n, patch * patch).T
    img = F.fold(cols[None], shape, patch, stride=stride)[0, 0]
    cnt = F.fold(torch.ones_like(cols)[None], shape, patch, stride=stride)[0, 0]
    return img / torch.clamp(cnt, min=1.0)


def psnr(clean: Tensor, est: Tensor, max_val: Optional[float] = None) -> Tensor:
    """Peak SNR (paper footnote 5): 10 log10(I_max^2 / MSE)."""
    mv = torch.max(clean) if max_val is None else max_val
    mse = torch.mean((clean - est) ** 2)
    return 10.0 * torch.log10(mv * mv / (mse + 1e-30))


@torch.no_grad()
def denoise_patches(learner, state, patches: Tensor, batch: int = 256) -> Tensor:
    """Denoise patch rows: infer nu (FISTA on the full dictionary), z = x - nu,
    add DC back.  Per-patch DC (mean) is removed before coding, as is
    standard for patch-based denoising."""
    dc = patches.mean(dim=-1, keepdim=True)
    x = patches - dc
    W = learner.dictionary(state)
    outs = []
    for i in range(0, x.shape[0], batch):
        xb = x[i : i + batch]
        nu = fista_infer(learner.res, learner.reg, W, xb, iters=learner.cfg.inference_iters)
        outs.append(xb - nu)  # z = x - nu (Table II, l2 row)
    return torch.cat(outs, dim=0) + dc


def denoise_image(learner, state, noisy, patch: int = 10, stride: int = 1,
                  batch: int = 256) -> Tensor:
    """The denoised image of `noisy` (an (H, W) array or tensor, moved to the
    learner's device)."""
    noisy = torch.as_tensor(noisy, dtype=torch.float32, device=learner.device)
    patches, grid = extract_patches(noisy, patch, stride)
    z = denoise_patches(learner, state, patches, batch=batch)
    return reconstruct_from_patches(z, grid, tuple(noisy.shape), patch, stride)
