"""Mamba2 (SSD) blocks: the chunked parallel form for train and prefill, the
recurrent state update for decode.

Port of src/repro/models/ssm.py.  The SSD recurrence per head (state S of
shape (d_state, head_dim)):

    S_t = a_t * S_{t-1} + dt_t * B_t (x) x_t          a_t = exp(dt_t * A)
    y_t = C_t^T S_t + D * x_t

The JAX side has no kernel for it: its chunked form is einsums and a scan
over chunks, plain torch here.  Within a chunk of length Q the causal
decay exp(L_i - L_j) is built in fp32 (masked to -inf above the diagonal
BEFORE the exp, as JAX does, so no inf reaches a gradient), laid out
(B, nc, H, Q, Q) so every intra-chunk product is one batched matmul; the
chunk summaries are one batched product too, and only the carried state
walks the chunks in order (a Python loop over nc, JAX's `lax.scan`).

The prefill's convolution adds the width's four products one after another
in the compute dtype, and decode's is one einsum over the rolling buffer,
each where JAX has it.  Decode steps update the cache in place (JAX returns
a new one); the cache layouts are the JAX ones.

On a mesh (models/sharding_hook installed, a `model` axis of tp ranks) the
mixer is tensor-parallel by heads, as JAX's GSPMD cuts its leaves
(`ssm_inner`, `ssm_heads` over `model`).  The fused leaves are cut
segment by segment (`segments`, the one table of them, read through
runtime/sharding's `Segmented` axis names): a rank holds 1/tp of each of
in_proj's [z | x | B | C | dt] columns and of the convolution's
[x | B | C] channels, so its product gives [z_r | x_r | B_r | C_r | dt_r]
and no activation or weight crosses the wire to regroup them.  Then:
`column_in` (the sequence's all-gather where the residual is sharded on
it, f otherwise) before the product; the causal convolution on the rank's
channels; the convolved B and C all-gathered over `model` on their
channel dim (every head reads all of them: one group), whose backward, a
psum-scatter, sums each rank's heads' parts of dB and dC; the SSD on the
rank's H/tp heads with their dt_bias, A_log and D; the gated RMSNorm with
the sum of squares over the whole d_inner psum'd both ways (forward and
backward: each rank uses the total on its own channels, so each one's
cotangent of it is needed everywhere; `hook.model_sum`); out_proj's rows
and `row_out`.  The decode cache on a rank: conv_buf's channels cut by
segment (the rank's raw [x_r | B_r | C_r]), S by heads (JAX's
MAMBA_CACHE_AXES).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import sharding_hook as hook
from repro_torch.models.layers import dense_init
from repro_torch.runtime.sharding import Segmented


def segments(d_inner: int, d_state: int, n_heads: int) -> dict:
    """The segment table of the fused Mamba2 leaves: the parts, by name and
    length, of in_proj's columns (z, x, B, C, dt) and of the convolution's
    channels (x, B, C: conv_w's dim 1, conv_b, the decode cache's
    conv_buf), each cut over `model` on its own."""
    xbc = {"x": d_inner, "B": d_state, "C": d_state}
    return {"in_proj": {"z": d_inner, **xbc, "dt": n_heads}, "xbc": xbc}


def mamba2_axes(d_inner: int, d_state: int, n_heads: int) -> dict:
    """The logical axes of init_mamba2's leaves (no layer dim), as JAX's;
    the fused dims name their segments (`segments`)."""
    seg = segments(d_inner, d_state, n_heads)
    proj, xbc = Segmented("ssm_inner", seg["in_proj"]), Segmented("ssm_inner", seg["xbc"])
    return {"in_proj": ("embed", proj), "conv_w": (None, xbc),
            "conv_b": (xbc,), "dt_bias": ("ssm_heads",), "A_log": ("ssm_heads",),
            "D": ("ssm_heads",), "norm_scale": ("ssm_inner",), "out_proj": ("ssm_inner", "embed")}


def _local(d_inner: int, d_state: int, n_heads: int) -> Tuple[int, int, int]:
    """(d_inner, d_state, n_heads) of the rank's parts on the installed mesh
    (the whole without one)."""
    tp = hook.model_size()
    return d_inner // tp, d_state // tp, n_heads // tp


def _whole_bc(Bm: torch.Tensor, Cm: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The rank's parts of B and C (..., N/tp) -> the whole (..., N) over
    `model` (backward: each rank's part of the summed gradient)."""
    if hook.model_size() == 1:
        return Bm, Cm
    both = hook.model_all_gather(torch.stack([Bm, Cm]), -1)
    return both[0], both[1]


def init_mamba2(
    gen: torch.Generator, d_model: int, *, d_state: int = 64, head_dim: int = 64,
    expand: int = 2, conv_width: int = 4, dtype: torch.dtype = torch.float32,
    lead: Tuple[int, ...] = (),
) -> dict:
    """Mamba2 params (with optional leading layer dims) in the JAX layouts:
    in_proj (D, 2 d_inner + 2 d_state + H) emitting [z, x, B, C, dt],
    conv_w (width, conv_dim) over [x, B, C], A_log = log(1 .. H)."""
    d_inner = expand * d_model
    n_heads = d_inner // head_dim
    conv_dim = d_inner + 2 * d_state
    d_proj = 2 * d_inner + 2 * d_state + n_heads
    dev = gen.device
    # log(1 .. H) rounded once from fp64: within an fp32 ulp of JAX's fp32 log.
    a_log = torch.log(torch.arange(1, n_heads + 1, dtype=torch.float64, device=dev)).float()
    return {
        "in_proj": dense_init(gen, (*lead, d_model, d_proj), dtype, fan_in=d_model),
        "conv_w": dense_init(gen, (*lead, conv_width, conv_dim), dtype, fan_in=conv_width),
        "conv_b": torch.zeros(*lead, conv_dim, dtype=dtype, device=dev),
        "dt_bias": torch.zeros(*lead, n_heads, dtype=dtype, device=dev),
        "A_log": a_log.to(dtype).expand(*lead, n_heads).clone(),
        "D": torch.ones(*lead, n_heads, dtype=dtype, device=dev),
        "norm_scale": torch.ones(*lead, d_inner, dtype=dtype, device=dev),
        "out_proj": dense_init(gen, (*lead, d_inner, d_model), dtype, fan_in=d_inner),
    }


def _split_proj(proj: torch.Tensor, d_inner: int, d_state: int):
    """[z, xbc, dt] of the in_proj output (of a rank's parts: its sizes)."""
    z = proj[..., :d_inner]
    xbc = proj[..., d_inner: 2 * d_inner + 2 * d_state]
    dt = proj[..., 2 * d_inner + 2 * d_state:]
    return z, xbc, dt


def _causal_conv(xbc: torch.Tensor, conv_w: torch.Tensor, conv_b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over the sequence, xbc (B, S, C), conv_w (W, C):
    the W products added one after another, then the bias and silu."""
    w, s = conv_w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, w - 1, 0))
    out = torch.zeros_like(xbc)
    for i in range(w):
        out = out + pad[:, i: i + s, :] * conv_w[i]
    return F.silu(out + conv_b)


def _ssd_chunked(
    x: torch.Tensor,  # (B, S, H, P) inputs
    dt: torch.Tensor,  # (B, S, H) softplus'd step sizes
    A: torch.Tensor,  # (H,) negative decay rates
    Bm: torch.Tensor,  # (B, S, N) input projection (one group: shared by the heads)
    Cm: torch.Tensor,  # (B, S, N)
    chunk: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD in fp32: y (B, S, H, P) and the final state S (B, H, N, P)."""
    b, s, h, p = x.shape
    n = Bm.shape[-1]
    q = min(chunk, s)
    while s % q:
        q //= 2
    nc = s // q

    xf = x.float().reshape(b, nc, q, h, p).movedim(3, 2)  # (B, nc, H, Q, P)
    dtf = dt.float().reshape(b, nc, q, h).movedim(3, 2)  # (B, nc, H, Q)
    Bf = Bm.float().reshape(b, nc, q, n)  # (B, nc, Q, N)
    Cf = Cm.float().reshape(b, nc, q, n)

    L = torch.cumsum(dtf * A.float()[:, None], dim=-1)  # inclusive log decay (<= 0)

    # Intra-chunk: att[i, j] = exp(L_i - L_j) * (C_i . B_j) * dt_j, i >= j.
    causal = torch.ones(q, q, dtype=torch.bool, device=x.device).tril()
    decay = torch.exp((L[..., :, None] - L[..., None, :]).masked_fill(~causal, -math.inf))
    cb = Cf @ Bf.transpose(-1, -2)  # (B, nc, Q, Q)
    att = decay * cb[:, :, None] * dtf[..., None, :]  # (B, nc, H, Q, Q)
    del decay
    y = att @ xf  # (B, nc, H, Q, P)
    del att

    # Chunk summaries: each state contribution decayed to the chunk's end.
    end_decay = torch.exp(L[..., -1:] - L)  # (B, nc, H, Q)
    s_chunk = Bf.transpose(-1, -2)[:, :, None] @ (xf * (dtf * end_decay)[..., None])
    chunk_decay = torch.exp(L[..., -1])  # (B, nc, H)

    # Inter-chunk: the state entering each chunk, chunk by chunk.
    S = torch.zeros(b, h, n, p, device=x.device)
    S_before = []
    for c in range(nc):
        S_before.append(S)
        S = S * chunk_decay[:, c, :, None, None] + s_chunk[:, c]
    S_before = torch.stack(S_before, dim=1)  # (B, nc, H, N, P)

    in_decay = torch.exp(L)  # (B, nc, H, Q): decay from the chunk's start to i
    y = y + (Cf[:, :, None] @ S_before) * in_decay[..., None]
    return y.movedim(2, 3).reshape(b, s, h, p), S


def _gated_out(params: dict, y: torch.Tensor, z: torch.Tensor, dt_in: torch.dtype,
               d_inner: int) -> torch.Tensor:
    """Mamba2's gated RMSNorm of the fp32 SSD output over the whole d_inner
    (the rank's channels' sum of squares psum'd both ways on a mesh), then
    out_proj's rows in dt_in and `row_out`."""
    y = y * F.silu(z.float())
    if hook.model_size() == 1:
        var = torch.mean(y * y, dim=-1, keepdim=True)
    else:
        var = hook.model_sum(torch.sum(y * y, dim=-1, keepdim=True)) / d_inner
    y = y * torch.rsqrt(var + 1e-6) * params["norm_scale"].float()
    return hook.row_out(y.to(dt_in) @ params["out_proj"].to(dt_in))


def _dt_and_A(params: dict, dt_raw: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """softplus(dt_raw + dt_bias) and A = -exp(A_log), both fp32."""
    dt = F.softplus(dt_raw.float() + params["dt_bias"].float())
    return dt, -torch.exp(params["A_log"].float())


def mamba2_block(params: dict, hidden: torch.Tensor, *, d_state: int, head_dim: int,
                 expand: int, chunk: int = 128, return_cache: bool = False,
                 conv_width: int = 4):
    """The Mamba2 mixer over hidden (B, S, D) (pre-norm is the caller's; on
    a mesh the rank's positions where the residual is sharded on its
    sequence, and the rank's heads: see the module's docstring).
    With return_cache also the decode cache after the sequence:
    {"conv_buf": the last min(S, width - 1) raw (pre-convolution) xbc rows,
    "S": the final SSD state (B, H, N, P) fp32} (on a mesh the rank's
    segments and heads)."""
    d_model = hidden.shape[-1]
    d_inner = expand * d_model
    di, ns, nh = _local(d_inner, d_state, d_inner // head_dim)
    dt_in = hidden.dtype

    h = hook.column_in(hidden)
    proj = h @ params["in_proj"].to(dt_in)
    z, xbc_raw, dt_raw = _split_proj(proj, di, ns)
    xbc = _causal_conv(xbc_raw, params["conv_w"].to(dt_in), params["conv_b"].to(dt_in))
    x = xbc[..., :di]
    Bm, Cm = _whole_bc(xbc[..., di: di + ns], xbc[..., di + ns:])
    dt, A = _dt_and_A(params, dt_raw)

    xh = x.reshape(*x.shape[:-1], nh, head_dim)
    y, S_last = _ssd_chunked(xh, dt, A, Bm, Cm, chunk)  # fp32 (B, S, H, P)
    y = y + params["D"].float()[:, None] * xh.float()
    out = _gated_out(params, y.reshape(*h.shape[:-1], di), z, dt_in, d_inner)
    if not return_cache:
        return out
    return out, {"conv_buf": xbc_raw[:, -(conv_width - 1):, :], "S": S_last}


# ---------------------------------------------------------------------------
# Decode (recurrent) path
# ---------------------------------------------------------------------------


def init_mamba2_cache(batch: int, d_model: int, *, d_state: int, head_dim: int, expand: int,
                      conv_width: int = 4, dtype: torch.dtype = torch.float32,
                      device: DeviceLike = "cuda", lead: Tuple[int, ...] = (),
                      model_ranks: int = 1) -> dict:
    """The zero Mamba2 decode state, with optional leading (layer) dims:
    conv_buf (*lead, B, width - 1, conv_dim) in `dtype`, S (*lead, B, H, N,
    P) fp32; with model_ranks, one rank's part (conv_dim / model_ranks
    channels, its segments; H / model_ranks heads).  On the card unless the
    CPU is asked for."""
    dev = resolve_device(device)
    d_inner = expand * d_model
    n_heads = d_inner // head_dim
    return {
        "conv_buf": torch.zeros(*lead, batch, conv_width - 1,
                                (d_inner + 2 * d_state) // model_ranks, dtype=dtype, device=dev),
        "S": torch.zeros(*lead, batch, n_heads // model_ranks, d_state, head_dim, device=dev),
    }


def mamba2_decode(params: dict, hidden: torch.Tensor, cache: dict, *, d_state: int,
                  head_dim: int, expand: int) -> Tuple[torch.Tensor, dict]:
    """One recurrent step on hidden (B, 1, D); the cache is updated in place
    and returned.  On a mesh: the rank's segments and heads, the convolved
    B and C of the token all-gathered over `model`."""
    d_model = hidden.shape[-1]
    d_inner = expand * d_model
    di, ns, nh = _local(d_inner, d_state, d_inner // head_dim)
    dt_in = hidden.dtype

    proj = hook.enter_model(hidden[:, 0]) @ params["in_proj"].to(dt_in)  # (B, d_proj)
    z, xbc, dt_raw = _split_proj(proj, di, ns)
    buf = torch.cat([cache["conv_buf"], xbc[:, None, :]], dim=1)  # (B, W, C)
    xbc_t = F.silu(torch.einsum("bwc,wc->bc", buf, params["conv_w"].to(dt_in))
                   + params["conv_b"].to(dt_in))
    cache["conv_buf"].copy_(buf[:, 1:, :])

    x = xbc_t[..., :di]
    Bm, Cm = (t.float() for t in _whole_bc(xbc_t[..., di: di + ns], xbc_t[..., di + ns:]))
    dt, A = _dt_and_A(params, dt_raw)
    a = torch.exp(dt * A)  # (B, H)

    xh = x.reshape(-1, nh, head_dim).float()
    S = cache["S"]  # (B, H, N, P): S <- a S + B (x) (dt x), in place
    S.mul_(a[..., None, None]).add_(Bm[:, None, :, None] * (dt[..., None] * xh)[:, :, None, :])
    y = (Cm[:, None, None, :] @ S)[:, :, 0] + params["D"].float()[:, None] * xh  # (B, H, P)
    out = _gated_out(params, y.reshape(-1, di), z, dt_in, d_inner)
    return out[:, None, :], cache


# ---------------------------------------------------------------------------
# Sequential reference (tests only)
# ---------------------------------------------------------------------------


def ssd_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
            Cm: torch.Tensor) -> torch.Tensor:
    """Step-by-step recurrence; the oracle of _ssd_chunked: y (B, S, H, P)."""
    b, s, h, p = x.shape
    a = torch.exp(dt.float() * A.float())  # (B, S, H)
    xf, dtf, Bf, Cf = x.float(), dt.float(), Bm.float(), Cm.float()
    S = torch.zeros(b, h, Bm.shape[-1], p, device=x.device)
    ys = []
    for t in range(s):
        S = S * a[:, t, :, None, None] + torch.einsum(
            "bn,bh,bhp->bhnp", Bf[:, t], dtf[:, t], xf[:, t])
        ys.append(torch.einsum("bn,bhnp->bhp", Cf[:, t], S))
    return torch.stack(ys, dim=1)
