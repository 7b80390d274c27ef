"""The gradient of flash attention: FlashAttention-2's backward in plain
PyTorch, fp32, a chunk of query rows at a time.

The JAX package has no backward kernel: its training path runs
`attn_impl="blockwise"`, an XLA online-softmax scan that XLA differentiates
(src/repro/models/attention.py:96).  This is the port's counterpart, the
backward of the function K2 computes, with its mask: causal aligned
bottom-right (query row r sees key c iff c <= r + T - S).  For each chunk
of query rows it recomputes the logits from q and k (nothing of the
forward is kept but q, k and v), so memory holds one chunk's (B, Hq, rows,
T) fp32 logits, not the whole S x T:

    P  = softmax(scale q k^T, masked)       D  = rowsum(P * dP)
    dP = dO v^T                             dS = P * (dP - D)
    dq = scale dS k     dk = scale dS^T q   dv = P^T dO

A chunk holds whole rows of P, so D is summed from the chunk's own fp32 P
and dP, and each row of dS sums to zero as the exact gradient's does.
FlashAttention-2's D = rowsum(dO * O), from the forward's bf16 output,
differs from it by O's rounding, which dS then carries into dq along the
mean key: where the keys share a large common part (the deep layers of a
random-weight stack) dq is then wrong by a large share of its size
(tests/test_torch_attention_grad.py).

dk and dv sum over the `group` query heads that read each kv head.  Under a
causal mask a chunk of rows ending at row r1 sees no key past r1 + T - S,
so each chunk multiplies only the keys it sees.
"""

from __future__ import annotations

from typing import Tuple

import torch

# fp32 bytes of one chunk's (B, Hq, rows, T) logits; the chunk's P, dP and
# dS are as large again each.
CHUNK_BYTES = 256 << 20


def chunk_rows(b: int, hq: int, s: int, t: int) -> int:
    """Query rows per chunk: CHUNK_BYTES of fp32 logits, at least 1, at most S."""
    return max(1, min(s, CHUNK_BYTES // (4 * b * hq * t)))


def softmax_grad(p: torch.Tensor, dp: torch.Tensor) -> torch.Tensor:
    """dS = P * (dP - rowsum(P * dP)) over whole rows, computed in dp's
    storage."""
    dp.mul_(p)
    return dp.addcmul_(p, dp.sum(-1, keepdim=True), value=-1.0)


def attention_backward(
    q: torch.Tensor,  # (B, Hq, S, D)
    k: torch.Tensor,  # (B, Hkv, T, D)
    v: torch.Tensor,  # (B, Hkv, T, D)
    dout: torch.Tensor,  # (B, Hq, S, D)
    *,
    causal: bool,
    scale: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of attention at (q, k, v), in their dtypes."""
    b, hq, s, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    group = hq // hkv
    # (B, Hkv, G, S, D): query head h is (h // group, h % group)
    qf = q.float().reshape(b, hkv, group, s, d)
    dof = dout.float().reshape(b, hkv, group, s, d)
    kf, vf = k.float(), v.float()
    dq = torch.empty_like(qf)
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    rows = chunk_rows(b, hq, s, t)
    for r0 in range(0, s, rows):
        r1 = min(s, r0 + rows)
        tc = min(t, r1 + t - s) if causal else t  # keys this chunk sees
        qc, doc = qf[:, :, :, r0:r1], dof[:, :, :, r0:r1]
        kc, vc = kf[:, :, :tc], vf[:, :, :tc]
        logits = torch.einsum("bhgsd,bhtd->bhgst", qc, kc) * scale
        if causal:
            r = torch.arange(r0, r1, device=q.device)[:, None]
            c = torch.arange(tc, device=q.device)[None, :]
            logits = logits.masked_fill(c > r + (t - s), float("-inf"))
        p = torch.softmax(logits, dim=-1)
        del logits
        ds = softmax_grad(p, torch.einsum("bhgsd,bhtd->bhgst", doc, vc))
        dq[:, :, :, r0:r1] = torch.einsum("bhgst,bhtd->bhgsd", ds, kc) * scale
        dk[:, :, :tc] += torch.einsum("bhgst,bhgsd->bhtd", ds, qc) * scale
        dv[:, :, :tc] += torch.einsum("bhgst,bhgsd->bhtd", p, doc)
        del p, ds
    return (dq.reshape(b, hq, s, d).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype))


def backward_flops(b: int, hq: int, s: int, t: int, d: int, causal: bool) -> int:
    """Multiply-add flops of attention_backward's five products (q k^T,
    dO v^T, dS k, dS^T q, P^T dO) as it runs them: each 2 D per (row, key)
    pair of a chunk, the keys a chunk sees."""
    rows, pairs = chunk_rows(b, hq, s, t), 0
    for r0 in range(0, s, rows):
        r1 = min(s, r0 + rows)
        pairs += (r1 - r0) * (min(t, r1 + t - s) if causal else t)
    return 5 * 2 * d * b * hq * pairs
