"""Attention: GQA/MQA with rotary, qk-norm, the flash-attention kernel
path, and KV-cache decode.

Port of src/repro/models/attention.py.  Paths, by `impl`:
  "blockwise", "pallas"  kernels/flash_attention.ops.flash_attention: K2,
                         the hand-written CUDA kernel, on the card (its
                         plain version on CPU tensors).  The JAX side's
                         "blockwise" is an XLA online-softmax scan over KV
                         blocks and its "pallas" the TPU kernel; both
                         compute the function K2 computes, and the JAX
                         suite holds the two to 1e-4 of each other
                         (tests/test_kernels.py), so routing both to K2
                         changes no result.
  "dense"                materialized logits, plain PyTorch.

Full-sequence attention runs over positions 0 .. S-1, so the positions'
causal mask (q_pos >= k_pos) is K2's index mask.  Decode attends one new
token to the cache with `flash_decode` (plain PyTorch, as the JAX side's is
plain jnp), and writes the new K/V into the cache in place.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.flash_attention import ops
from repro_torch.models.layers import (
    apply_rotary,
    dense_init,
    init_norm,
    rmsnorm,
    rotary_angles,
)


def init_attention(
    gen: torch.Generator,
    d_model: int,
    n_heads: int,
    n_kv: int,
    head_dim: int,
    *,
    qk_norm: bool = False,
    dtype: torch.dtype = torch.float32,
    lead: Tuple[int, ...] = (),
) -> dict:
    """Attention params (with optional leading layer dims) in the JAX
    layouts: wq (D, H, Dh), wk/wv (D, Hkv, Dh), wo (H, Dh, D)."""
    p = {
        "wq": dense_init(gen, (*lead, d_model, n_heads, head_dim), dtype, fan_in=d_model),
        "wk": dense_init(gen, (*lead, d_model, n_kv, head_dim), dtype, fan_in=d_model),
        "wv": dense_init(gen, (*lead, d_model, n_kv, head_dim), dtype, fan_in=d_model),
        "wo": dense_init(gen, (*lead, n_heads, head_dim, d_model), dtype,
                         fan_in=n_heads * head_dim),
    }
    if qk_norm:
        p["q_norm"] = init_norm("rms", head_dim, dtype, gen.device, lead)
        p["k_norm"] = init_norm("rms", head_dim, dtype, gen.device, lead)
    return p


def _heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (B, S, D) @ w (D, H, Dh) -> (B, S, H, Dh), as one matrix product."""
    d, h, dh = w.shape
    return (x @ w.reshape(d, h * dh)).view(*x.shape[:-1], h, dh)


def _out_proj(out: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """out (B, S, H, Dh) . wo (H, Dh, D) -> (B, S, D)."""
    h, dh, d = wo.shape
    return out.reshape(*out.shape[:-2], h * dh) @ wo.reshape(h * dh, d)


def _project_qkv(
    params: dict, x: torch.Tensor, positions: torch.Tensor, *, qk_norm: bool,
    rope: bool, rope_base: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> q (B, S, H, Dh), k/v (B, S, Hkv, Dh)."""
    q = _heads(x, params["wq"])
    k = _heads(x, params["wk"])
    v = _heads(x, params["wv"])
    if qk_norm:
        q = rmsnorm(params["q_norm"], q)
        k = rmsnorm(params["k_norm"], k)
    if rope:
        sin, cos = rotary_angles(positions, q.shape[-1], rope_base)  # (S, Dh/2)
        sin, cos = sin[..., None, :], cos[..., None, :]  # broadcast over heads
        q = apply_rotary(q, sin, cos)
        k = apply_rotary(k, sin, cos)
    return q, k, v


def _dense_attention(q, k, v, *, causal: bool, q_pos, k_pos) -> torch.Tensor:
    """q (B, S, H, D); k/v (B, T, Hkv, D). Materialized logits."""
    b, s, h, d = q.shape
    hkv = k.shape[2]
    group = h // hkv
    qg = q.reshape(b, s, hkv, group, d)
    logits = torch.einsum("bshgd,bthd->bhgst", qg.float(), k.float()) * (d ** -0.5)
    if causal:
        mask = q_pos[:, None] >= k_pos[None, :]
        logits = torch.where(mask, logits, logits.new_tensor(-1e30))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgst,bthd->bshgd", probs.to(v.dtype).float(), v.float())
    return out.reshape(b, s, h, d).to(q.dtype)


def _full_attention(q, k, v, positions, *, causal: bool, impl: str) -> torch.Tensor:
    if impl == "dense":
        return _dense_attention(q, k, v, causal=causal, q_pos=positions, k_pos=positions)
    if impl in ("blockwise", "pallas"):
        # (B, S, H, D) -> (B, H, S, D) views: K2 reads them through strides,
        # and its output keeps q's layout, so the transpose back is free.
        return ops.flash_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), causal=causal
        ).transpose(1, 2)
    raise KeyError(impl)


def attention(
    params: dict,
    x: torch.Tensor,  # (B, S, D)
    positions: torch.Tensor,  # (S,) = 0 .. S-1
    *,
    causal: bool = True,
    qk_norm: bool = False,
    rope: bool = True,
    rope_base: float = 10000.0,
    impl: str = "blockwise",
) -> torch.Tensor:
    """Self-attention over the full sequence (training / prefill)."""
    q, k, v = _project_qkv(params, x, positions, qk_norm=qk_norm, rope=rope, rope_base=rope_base)
    return _out_proj(_full_attention(q, k, v, positions, causal=causal, impl=impl), params["wo"])


def prefill_attention(
    params: dict,
    x: torch.Tensor,  # (B, S, D)
    positions: torch.Tensor,  # (S,) = 0 .. S-1
    *,
    causal: bool = True,
    qk_norm: bool = False,
    rope: bool = True,
    rope_base: float = 10000.0,
    impl: str = "blockwise",
) -> Tuple[torch.Tensor, dict]:
    """Full-sequence attention that also emits the KV cache (post-rope) so a
    decode loop can continue from position S."""
    q, k, v = _project_qkv(params, x, positions, qk_norm=qk_norm, rope=rope, rope_base=rope_base)
    out = _full_attention(q, k, v, positions, causal=causal, impl=impl)
    return _out_proj(out, params["wo"]), {"k": k, "v": v}


# ---------------------------------------------------------------------------
# KV-cache decode
# ---------------------------------------------------------------------------


def init_cache(
    batch: int, max_len: int, n_kv: int, head_dim: int, dtype: torch.dtype, device,
    lead: Tuple[int, ...] = (),
) -> dict:
    """Zero KV cache, (*lead, B, max_len, Hkv, Dh) for k and v."""
    shape = (*lead, batch, max_len, n_kv, head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
    }


def decode_attention(
    params: dict,
    x: torch.Tensor,  # (B, 1, D) current token hidden
    cache: dict,
    pos: int,  # write index == current position
    *,
    qk_norm: bool = False,
    rope: bool = True,
    rope_base: float = 10000.0,
) -> Tuple[torch.Tensor, dict]:
    """One decode step: write K/V at `pos` (in place), attend to cache[:pos+1]."""
    b = x.shape[0]
    pos = int(pos)
    positions = torch.full((1,), pos, dtype=torch.int64, device=x.device)
    q, k, v = _project_qkv(params, x, positions, qk_norm=qk_norm, rope=rope, rope_base=rope_base)
    cache["k"][:, pos] = k[:, 0]
    cache["v"][:, pos] = v[:, 0]
    out = ops.flash_decode(
        q.transpose(1, 2),  # (B, H, 1, D)
        cache["k"].transpose(1, 2),
        cache["v"].transpose(1, 2),
        length=torch.full((b,), pos + 1, dtype=torch.int64, device=x.device),
    ).transpose(1, 2)  # (B, 1, H, D)
    return _out_proj(out, params["wo"]), cache
