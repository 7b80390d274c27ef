"""Plain PyTorch version of flash attention (GQA, optional causal).

Port of src/repro/kernels/flash_attention/ref.py: materialised fp32 logits,
GQA by repeating the kv heads, the causal mask aligned bottom-right (query
row r sees key c iff c <= r + (T - S)) and filled with -inf, softmax in
fp32, probabilities cast to v's dtype before the P V product, which sums in
fp32; the output is cast to q's dtype.
"""

from __future__ import annotations

from typing import Optional

import torch


def attention_ref(
    q: torch.Tensor,  # (B, Hq, S, D)
    k: torch.Tensor,  # (B, Hkv, T, D)
    v: torch.Tensor,  # (B, Hkv, T, D)
    *,
    causal: bool = True,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Materialised-softmax reference attention with GQA head grouping."""
    _, hq, s, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    group = hq // hkv
    scale = d ** -0.5 if scale is None else scale

    kx = k.repeat_interleave(group, dim=1)  # (B, Hq, T, D)
    vx = v.repeat_interleave(group, dim=1)
    logits = torch.matmul(q.float(), kx.float().transpose(-1, -2)) * scale
    if causal:
        mask = torch.ones(s, t, dtype=torch.bool, device=q.device).tril(diagonal=t - s)
        logits = logits.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    out = torch.matmul(probs.to(v.dtype).float(), vx.float())
    return out.to(q.dtype)
