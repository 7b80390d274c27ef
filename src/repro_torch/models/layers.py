"""Shared building blocks of the LM zoo: norms, rotary embeddings, MLPs,
embedding and unembedding, and the parameter initialisers.

Port of src/repro/models/layers.py.  Parameters are plain dicts of tensors
in the JAX package's layouts (a matrix is (fan_in, fan_out)); the JAX
side's `Param` leaves and their logical axes (sharding metadata) have no
counterpart on one card.  Numerics follow the JAX functions: norms in fp32
cast back to the input dtype, rotary angles in fp32, GeGLU with the tanh
GELU (`jax.nn.gelu`'s default), the embedding scaled by sqrt(d) in the
table's dtype, and fp32 logits from the unembedding.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------


def dense_init(
    gen: torch.Generator, shape: Sequence[int], dtype: torch.dtype, *, fan_in: int
) -> torch.Tensor:
    """Plain normal with stddev 1 / sqrt(fan_in), on gen's device, drawn in
    fp32.  A tensor of another dtype is drawn in slabs of at most 2^26
    elements along its leading dims, each cast into place, so no fp32 copy
    of the whole tensor is ever held (one of kimi-k2's bf16 expert stacks
    is 11.3 GB, 22.5 GB in fp32)."""
    shape = tuple(shape)
    if dtype == torch.float32:
        w = torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float32)
        return w * fan_in ** -0.5
    out = torch.empty(shape, dtype=dtype, device=gen.device)
    rows = out.view(-1, shape[-1]) if shape else out.view(1, 1)
    step = max(1, (1 << 26) // rows.shape[1])
    for i in range(0, rows.shape[0], step):
        part = rows[i:i + step]
        w = torch.randn(part.shape, generator=gen, device=gen.device, dtype=torch.float32)
        part.copy_(w * fan_in ** -0.5)
    return out


def init_norm(kind: str, d: int, dtype: torch.dtype, device, lead: Tuple[int, ...] = ()) -> dict:
    """Norm params with optional leading (layer) dims: rms has a scale of
    ones, nonparametric has none."""
    if kind == "rms":
        return {"scale": torch.ones(*lead, d, dtype=dtype, device=device)}
    if kind == "nonparametric":
        return {}
    raise KeyError(kind)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rmsnorm(params: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """x / rms(x) * scale, in fp32, cast back to x's dtype (scale, not the
    1 + scale of Gemma's reference code)."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(x.dtype)


def nonparametric_layernorm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """OLMo-style LN: standardize, no learned scale/bias."""
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype)


def apply_norm(kind: str, params: dict, x: torch.Tensor) -> torch.Tensor:
    if kind == "rms":
        return rmsnorm(params, x)
    if kind == "nonparametric":
        return nonparametric_layernorm(x)
    raise KeyError(kind)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------


def rotary_angles(
    positions: torch.Tensor, head_dim: int, base: float = 10000.0
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sin, cos) of shape (..., head_dim/2) for integer positions."""
    half = head_dim // 2
    idx = torch.arange(0, half, dtype=torch.float32, device=positions.device)
    freqs = base ** (-idx / half)
    ang = positions.float()[..., None] * freqs  # (..., half)
    return torch.sin(ang), torch.cos(ang)


def apply_rotary(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor) -> torch.Tensor:
    """x (..., S, H, D) with sin/cos (..., S, 1, D/2) or broadcastable; the
    two halves of the head dim rotate together (split halves)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# MLP variants
# ---------------------------------------------------------------------------


def init_mlp(
    gen: torch.Generator, d_model: int, d_ff: int, act: str, dtype: torch.dtype,
    lead: Tuple[int, ...] = (),
) -> dict:
    """MLP params with optional leading (layer) dims."""
    p = {
        "wi": dense_init(gen, (*lead, d_model, d_ff), dtype, fan_in=d_model),
    }
    if act in ("swiglu", "geglu"):
        p["wg"] = dense_init(gen, (*lead, d_model, d_ff), dtype, fan_in=d_model)
    p["wo"] = dense_init(gen, (*lead, d_ff, d_model), dtype, fan_in=d_ff)
    return p


def apply_mlp(params: dict, x: torch.Tensor, act: str) -> torch.Tensor:
    if act == "swiglu":
        h = F.silu(x @ params["wg"]) * (x @ params["wi"])
    elif act == "geglu":
        h = F.gelu(x @ params["wg"], approximate="tanh") * (x @ params["wi"])
    elif act == "gelu":
        h = F.gelu(x @ params["wi"], approximate="tanh")
    else:
        raise KeyError(act)
    return h @ params["wo"]


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------


def init_embedding(gen: torch.Generator, vocab: int, d_model: int, dtype: torch.dtype) -> dict:
    return {"table": dense_init(gen, (vocab, d_model), dtype, fan_in=d_model)}


def embed(params: dict, tokens: torch.Tensor, scale_by_dim: bool = False) -> torch.Tensor:
    table = params["table"]
    out = table[tokens]
    if scale_by_dim:  # gemma convention: the scale is rounded to the table's dtype
        out = out * torch.tensor(table.shape[1] ** 0.5, dtype=out.dtype, device=out.device)
    return out


def unembed(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Tied unembedding: logits = x @ table^T in fp32.

    The JAX side asks for an fp32 result of the (compute-dtype) product; a
    bf16 GEMM would round its output to bf16, so both operands are widened
    to fp32 first (exact for bf16 values) and the product runs in IEEE fp32."""
    return torch.matmul(x.float(), params["table"].float().t())
