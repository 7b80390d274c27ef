"""Decoder blocks: the pre-norm residual unit of the dense and MoE families.

    h = h + attention(norm1(h))
    h = h + ffn(norm2(h))        # a dense MLP, or the MoE FFN with experts

Port of the block part of src/repro/models/transformer.py.  A block with
experts (`cfg.n_experts`) holds a "moe" subtree in place of "mlp"; kimi's
leading dense layers are `init_dense_block`s (`dense_d_ff`).  Every block
returns its MoE load-balance aux beside h (0 without experts), as JAX's
does.  The FFN of an MoE block is `_moe_ffn`: on one card always the
capacity dispatch of models/moe.py (the JAX side's all-to-all path needs a
mesh whose model axis is larger than 1), with `cfg.moe_groups` groups over
a full sequence and one group in a decode step.  The JAX side's
activation-sharding hook has no counterpart on one card.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.models import attention as attn_mod
from repro_torch.models.layers import apply_mlp, apply_norm, init_mlp, init_norm
from repro_torch.models.moe import apply_moe, init_moe


def _init_attention_half(gen: torch.Generator, cfg, lead) -> dict:
    return {
        "norm1": init_norm(cfg.norm, cfg.d_model, cfg.dtype, gen.device, lead),
        "attn": attn_mod.init_attention(
            gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim,
            qk_norm=cfg.qk_norm, dtype=cfg.dtype, lead=lead,
        ),
        "norm2": init_norm(cfg.norm, cfg.d_model, cfg.dtype, gen.device, lead),
    }


def init_block(gen: torch.Generator, cfg, n: int = 1) -> dict:
    """Params of n decoder blocks stacked on a leading layer axis: "moe"
    when cfg has experts, else "mlp"."""
    lead = (n,)
    p = _init_attention_half(gen, cfg, lead)
    if cfg.n_experts:
        p["moe"] = init_moe(gen, cfg.d_model, cfg.moe_d_ff or cfg.d_ff, cfg.n_experts,
                            n_shared=cfg.n_shared_experts, dtype=cfg.dtype, lead=lead)
    else:
        p["mlp"] = init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.act, cfg.dtype, lead)
    return p


def init_dense_block(gen: torch.Generator, cfg, n: int = 1) -> dict:
    """n dense blocks even when cfg is MoE (kimi's first layer), with an
    MLP of width dense_d_ff or d_ff."""
    p = _init_attention_half(gen, cfg, (n,))
    p["mlp"] = init_mlp(gen, cfg.d_model, cfg.dense_d_ff or cfg.d_ff, cfg.act, cfg.dtype, (n,))
    return p


def _moe_ffn(moe_params: dict, f_in: torch.Tensor, cfg, n_groups: int):
    return apply_moe(moe_params, f_in, top_k=cfg.top_k, n_groups=n_groups,
                     capacity_factor=cfg.capacity_factor)


def _ffn(params: dict, h: torch.Tensor, cfg, n_groups: int) -> Tuple[torch.Tensor, torch.Tensor]:
    f_in = apply_norm(cfg.norm, params["norm2"], h)
    if "moe" in params:
        f_out, aux = _moe_ffn(params["moe"], f_in, cfg, n_groups)
    else:
        f_out = apply_mlp(params["mlp"], f_in, cfg.act)
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
    return h + f_out, aux


def apply_block(params: dict, h: torch.Tensor, positions: torch.Tensor, cfg, *,
                causal=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """One block over the full sequence, h (B, S, D): (h, moe_aux)."""
    causal = cfg.causal if causal is None else causal
    a_in = apply_norm(cfg.norm, params["norm1"], h)
    h = h + attn_mod.attention(
        params["attn"], a_in, positions,
        causal=causal, qk_norm=cfg.qk_norm, rope=True, rope_base=cfg.rope_base,
        impl=cfg.attn_impl,
    )
    return _ffn(params, h, cfg, cfg.moe_groups)


def prefill_block(params: dict, h: torch.Tensor, positions: torch.Tensor,
                  cfg) -> Tuple[torch.Tensor, dict, torch.Tensor]:
    """apply_block that also emits this layer's KV cache: (h, kv, moe_aux)."""
    a_in = apply_norm(cfg.norm, params["norm1"], h)
    a_out, kv = attn_mod.prefill_attention(
        params["attn"], a_in, positions,
        causal=cfg.causal, qk_norm=cfg.qk_norm, rope=True, rope_base=cfg.rope_base,
        impl=cfg.attn_impl,
    )
    h, aux = _ffn(params, h + a_out, cfg, cfg.moe_groups)
    return h, kv, aux


def decode_block(params: dict, h: torch.Tensor, cache: dict, pos: int,
                 cfg) -> Tuple[torch.Tensor, dict, torch.Tensor]:
    """One decode step through a block, h (B, 1, D); the cache is updated
    in place.  The MoE FFN dispatches the step's B tokens as one group.
    Returns (h, cache, moe_aux)."""
    a_in = apply_norm(cfg.norm, params["norm1"], h)
    a_out, cache = attn_mod.decode_attention(
        params["attn"], a_in, cache, pos,
        qk_norm=cfg.qk_norm, rope=True, rope_base=cfg.rope_base,
    )
    h, aux = _ffn(params, h + a_out, cfg, 1)
    return h, cache, aux
