"""Decoder blocks: the pre-norm residual unit of the dense LM family.

    h = h + attention(norm1(h))
    h = h + mlp(norm2(h))

Port of the dense-block part of src/repro/models/transformer.py.  A block
with experts (`cfg.n_experts`) belongs to the MoE slice, which is not
ported yet; asking for one raises.  The JAX side's activation-sharding hook
has no counterpart on one card.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.models import attention as attn_mod
from repro_torch.models.layers import apply_mlp, apply_norm, init_mlp, init_norm


def _dense_only(cfg) -> None:
    if cfg.n_experts:
        raise NotImplementedError(
            f"{cfg.name}: blocks with experts are not ported yet (ROADMAP "
            f"section 1, the MoE slice)"
        )


def init_block(gen: torch.Generator, cfg, n: int = 1) -> dict:
    """Params of n decoder blocks stacked on a leading layer axis."""
    _dense_only(cfg)
    lead = (n,)
    dev = gen.device
    return {
        "norm1": init_norm(cfg.norm, cfg.d_model, cfg.dtype, dev, lead),
        "attn": attn_mod.init_attention(
            gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim,
            qk_norm=cfg.qk_norm, dtype=cfg.dtype, lead=lead,
        ),
        "norm2": init_norm(cfg.norm, cfg.d_model, cfg.dtype, dev, lead),
        "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.act, cfg.dtype, lead),
    }


def _ffn(params: dict, h: torch.Tensor, cfg) -> torch.Tensor:
    _dense_only(cfg)
    return h + apply_mlp(params["mlp"], apply_norm(cfg.norm, params["norm2"], h), cfg.act)


def apply_block(params: dict, h: torch.Tensor, positions: torch.Tensor, cfg, *,
                causal=None) -> torch.Tensor:
    """One block over the full sequence, h (B, S, D)."""
    causal = cfg.causal if causal is None else causal
    a_in = apply_norm(cfg.norm, params["norm1"], h)
    h = h + attn_mod.attention(
        params["attn"], a_in, positions,
        causal=causal, qk_norm=cfg.qk_norm, rope=True, rope_base=cfg.rope_base,
        impl=cfg.attn_impl,
    )
    return _ffn(params, h, cfg)


def prefill_block(params: dict, h: torch.Tensor, positions: torch.Tensor,
                  cfg) -> Tuple[torch.Tensor, dict]:
    """apply_block that also emits this layer's KV cache."""
    a_in = apply_norm(cfg.norm, params["norm1"], h)
    a_out, kv = attn_mod.prefill_attention(
        params["attn"], a_in, positions,
        causal=cfg.causal, qk_norm=cfg.qk_norm, rope=True, rope_base=cfg.rope_base,
        impl=cfg.attn_impl,
    )
    return _ffn(params, h + a_out, cfg), kv


def decode_block(params: dict, h: torch.Tensor, cache: dict, pos: int,
                 cfg) -> Tuple[torch.Tensor, dict]:
    """One decode step through a block, h (B, 1, D); the cache is updated
    in place."""
    a_in = apply_norm(cfg.norm, params["norm1"], h)
    a_out, cache = attn_mod.decode_attention(
        params["attn"], a_in, cache, pos,
        qk_norm=cfg.qk_norm, rope=True, rope_base=cfg.rope_base,
    )
    return _ffn(params, h + a_out, cfg), cache
