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
causal mask (q_pos >= k_pos) is K2's index mask.

On a mesh whose `model` axis shards the heads (models/sharding_hook), a
rank attends over its H/tp query heads: q, k and v are column-parallel
(the input enters through Megatron's f), K2 runs on the local (H/tp,
Hkv/tp) heads, and the out-projection is row-parallel (its output leaves
through g, the psum over `model`).  When the rules' divisibility fallback
leaves kv_heads whole while heads are sharded, the rank keeps every kv
head and gives each local query head the kv head of its global index (a
narrowed view where the local heads share whole kv heads); wk, wv and the
qk-norm scales then serve only part of the work on each rank, so they
enter through f too, which sums their gradients over `model`.

Where the residual is sharded on its sequence over `model` (Megatron's
sequence parallelism, models/sharding_hook), the normed slice is
all-gathered in place of f and the out-projection's partial sums are
psum-scattered back to the rank's positions in place of g; K2 then runs
on the rank's heads over the gathered sequence, as on the replicated
layout.

The prefill runs the same tensor-parallel path and keeps the K/V it
attended over (the whole sequence's).  Decode attends one new token to the cache with
`flash_decode` (plain PyTorch, as the JAX side's is plain jnp), and writes
the new K/V into the cache in place; on a mesh over the cache's layout
(`decode_attention`): heads-sharded, replicated, or sharded on its
sequence with the parts combined by their log-sum-exp.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.flash_attention import ops
from repro_torch.models import sharding_hook as hook
from repro_torch.models.layers import (
    apply_rotary,
    dense_init,
    init_norm,
    norm_axes,
    rmsnorm,
    rotary_angles,
)
from repro_torch.runtime.mesh import MODEL_AXIS


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


def attention_axes(qk_norm: bool = False) -> dict:
    """The logical axes of init_attention's leaves (no layer dim)."""
    p = {"wq": ("embed", "heads", None), "wk": ("embed", "kv_heads", None),
         "wv": ("embed", "kv_heads", None), "wo": ("heads", None, "embed")}
    if qk_norm:
        p["q_norm"] = norm_axes("rms")
        p["k_norm"] = norm_axes("rms")
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


def _local_kv(k: torch.Tensor, v: torch.Tensor, n_heads: int, h_loc: int):
    """Every kv head (B, S, Hkv, Dh) -> the kv heads of this rank's query
    heads [r h_loc, (r + 1) h_loc): a narrowed view when the local heads
    cover whole groups or share one kv head, else one kv head per query
    head."""
    n_kv = k.shape[2]
    group = n_heads // n_kv
    lo = hook.model_index() * h_loc
    if h_loc % group == 0:
        return k.narrow(2, lo // group, h_loc // group), v.narrow(2, lo // group, h_loc // group)
    if group % h_loc == 0:
        return k.narrow(2, lo // group, 1), v.narrow(2, lo // group, 1)
    idx = (lo + torch.arange(h_loc, device=k.device)) // group
    return k.index_select(2, idx), v.index_select(2, idx)


def _attend(params: dict, x: torch.Tensor, positions: torch.Tensor, *, causal: bool,
            qk_norm: bool, rope: bool, rope_base: float, impl: str, n_heads: int, n_kv: int):
    """(out (B, S, D), k, v): self-attention over the full sequence, and the
    K/V it attended over (post-rope: the rank's kv heads, or every kv head
    when kv is whole on a mesh).  Where the residual is sharded on its
    sequence (models/sharding_hook), x and out are the rank's slice of the
    S positions, and q, k, v those of the whole sequence, gathered before
    the projections; positions are the whole sequence's."""
    h_loc = params["wq"].shape[-2]
    if not n_heads or h_loc == n_heads:  # every head on every rank
        q, k, v = _project_qkv(params, hook.seq_whole(x), positions, qk_norm=qk_norm,
                               rope=rope, rope_base=rope_base)
        return (hook.seq_part(_out_proj(_full_attention(q, k, v, positions, causal=causal,
                                                        impl=impl), params["wo"])), k, v)
    kv_whole = params["wk"].shape[-2] == n_kv
    p = dict(params)
    shared = (["wk", "wv"] if kv_whole else []) + (["q_norm", "k_norm"] if qk_norm else [])
    for name in shared:  # replicated, but each rank uses part: sum their gradients
        p[name] = (hook.enter_model(p[name]) if isinstance(p[name], torch.Tensor)
                   else {"scale": hook.enter_model(p[name]["scale"])})
    q, k, v = _project_qkv(p, hook.column_in(x), positions, qk_norm=qk_norm, rope=rope,
                           rope_base=rope_base)
    k_att, v_att = _local_kv(k, v, n_heads, h_loc) if kv_whole else (k, v)
    out = _full_attention(q, k_att, v_att, positions, causal=causal, impl=impl)
    return hook.row_out(_out_proj(out, params["wo"])), k, v


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
    n_heads: int = 0,
    n_kv: int = 0,
) -> torch.Tensor:
    """Self-attention over the full sequence (training / prefill).  n_heads
    and n_kv are the global head counts: with fewer query heads in wq (the
    heads sharded over `model`), the tensor-parallel path."""
    return _attend(params, x, positions, causal=causal, qk_norm=qk_norm, rope=rope,
                   rope_base=rope_base, impl=impl, n_heads=n_heads, n_kv=n_kv)[0]


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
    n_heads: int = 0,
    n_kv: int = 0,
) -> Tuple[torch.Tensor, dict]:
    """Full-sequence attention that also emits the KV cache (post-rope) so a
    decode loop can continue from position S.  On a mesh (n_heads, n_kv the
    global counts), the tensor-parallel path of `attention`, and the K/V of
    the rank's kv heads (every kv head when kv is whole)."""
    out, k, v = _attend(params, x, positions, causal=causal, qk_norm=qk_norm, rope=rope,
                        rope_base=rope_base, impl=impl, n_heads=n_heads, n_kv=n_kv)
    return out, {"k": k, "v": v}


# ---------------------------------------------------------------------------
# KV-cache decode
# ---------------------------------------------------------------------------


def init_cache(
    batch: int, max_len: int, n_kv: int, head_dim: int, dtype: torch.dtype, device,
    lead: Tuple[int, ...] = (),
) -> dict:
    """Zero KV cache, (*lead, B, max_len, Hkv, Dh) for k and v (on a mesh,
    the rank's shard: its rows, positions and kv heads)."""
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
    n_heads: int = 0,
    n_kv: int = 0,
    seq_sharded: bool = False,
) -> Tuple[torch.Tensor, dict]:
    """One decode step: write K/V at `pos` (in place), attend to cache[:pos+1].

    On a mesh (n_heads, n_kv the global head counts), by the cache's layout:
      heads-sharded (the cache holds the rank's kv heads): the rank's query
        heads over its kv heads, the out-projection row-parallel (g);
      replicated (every kv head, every position): the rank's query heads
        over the kv heads of their groups (`_local_kv`), then g;
      seq_sharded (the rank's max_len / tp positions, every kv head): every
        query head (an all_gather of the local heads over `model`) over the
        rank's positions (`ops.flash_decode_part`), the parts combined by
        their log-sum-exp (an all_gather of out, m and l,
        `ops.combine_decode_parts`), then the rank's heads through its wo
        shard and g.  The new K/V (every kv head: gathered over `model`
        when wk is sharded) is written only by the rank that holds `pos`."""
    b = x.shape[0]
    pos = int(pos)
    positions = torch.full((1,), pos, dtype=torch.int64, device=x.device)
    q, k, v = _project_qkv(params, x, positions, qk_norm=qk_norm, rope=rope, rope_base=rope_base)
    h_loc = params["wq"].shape[-2]
    tp = bool(n_heads) and h_loc != n_heads  # the query heads sharded over `model`
    if seq_sharded:
        return _decode_seq_sharded(params, q, k, v, cache, pos, tp, n_kv), cache
    cache["k"][:, pos] = k[:, 0]
    cache["v"][:, pos] = v[:, 0]
    k_all, v_all = cache["k"], cache["v"]
    if tp and k_all.shape[2] == n_kv:  # kv whole: the kv heads of the rank's query heads
        k_all, v_all = _local_kv(k_all, v_all, n_heads, h_loc)
    out = ops.flash_decode(
        q.transpose(1, 2),  # (B, H, 1, D)
        k_all.transpose(1, 2),
        v_all.transpose(1, 2),
        length=torch.full((b,), pos + 1, dtype=torch.int64, device=x.device),
    ).transpose(1, 2)  # (B, 1, H, D)
    out = _out_proj(out, params["wo"])
    return (hook.leave_model(out) if tp else out), cache


def _slot_of(pos: int, t_loc: int, r: int):
    """The index of position `pos` in rank r's part of a cache sharded on
    its sequence in parts of t_loc positions (None where another rank holds
    it)."""
    return pos - r * t_loc if pos // t_loc == r else None


def _decode_seq_sharded(params, q, k, v, cache, pos: int, tp: bool, n_kv: int) -> torch.Tensor:
    """decode_attention on a cache sharded on its sequence over `model`."""
    mesh = hook.current_mesh()
    r = mesh.index(MODEL_AXIS)
    b, t_loc = q.shape[0], cache["k"].shape[1]
    if k.shape[2] != n_kv:  # wk sharded: the new token's every kv head
        k = mesh.all_gather_tiled(k, MODEL_AXIS, 2)
        v = mesh.all_gather_tiled(v, MODEL_AXIS, 2)
    slot = _slot_of(pos, t_loc, r)
    if slot is not None:
        cache["k"][:, slot] = k[:, 0]
        cache["v"][:, slot] = v[:, 0]
    q_all = mesh.all_gather_tiled(q, MODEL_AXIS, 2) if tp else q  # (B, 1, H, Dh)
    valid = min(max(pos + 1 - r * t_loc, 0), t_loc)
    part = ops.flash_decode_part(
        q_all.transpose(1, 2), cache["k"].transpose(1, 2), cache["v"].transpose(1, 2),
        length=torch.full((b,), valid, dtype=torch.int64, device=q.device))
    packed = torch.cat([part[0], part[1][..., None], part[2][..., None]], dim=-1)
    parts = mesh.all_gather_tiled(packed[None], MODEL_AXIS, 0)  # (tp, B, H, Dh + 2)
    dh = q.shape[-1]
    out = ops.combine_decode_parts(parts[..., :dh], parts[..., dh], parts[..., dh + 1])
    out = out.to(q.dtype)[:, None]  # (B, 1, H, Dh)
    if not tp:
        return _out_proj(out, params["wo"])
    h_loc = q.shape[2]
    return hook.leave_model(_out_proj(out.narrow(2, r * h_loc, h_loc), params["wo"]))
