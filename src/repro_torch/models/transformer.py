"""Decoder blocks: the pre-norm residual unit of the dense and MoE families
(and the hybrid family's weight-tied shared block).

    h = h + attention(norm1(h))
    h = h + ffn(norm2(h))        # a dense MLP, or the MoE FFN with experts

Port of the block part of src/repro/models/transformer.py, and of its two
stub front ends: the VLM projector (phi-3-vision: precomputed CLIP patch
embeddings through gelu(x W1) W2) and the audio frame projection (hubert:
precomputed frame features through one matrix).  A block with
experts (`cfg.n_experts`) holds a "moe" subtree in place of "mlp"; kimi's
leading dense layers are `init_dense_block`s (`dense_d_ff`).  Every block
returns its MoE load-balance aux beside h (0 without experts), as JAX's
does.

With no mesh installed (models/sharding_hook) the FFN of an MoE block is
the capacity dispatch of models/moe.py, with `cfg.moe_groups` groups over
a full sequence and one group in a decode step.  On a mesh:
  * attention runs on the rank's heads (models/attention.py) and the dense
    MLP is column- then row-parallel over `model` (f before wi/wg, g after
    wo) when its ffn is sharded;
  * the MoE FFN takes the all-to-all path of models/moe_a2a.py exactly
    when JAX's does: moe_impl "a2a", a `model` axis of tp > 1, n_experts %
    tp == 0, S % tp == 0 (and B % dp == 0, the step's batch split).
    Otherwise (a decode step's S = 1, E or S not divisible by tp, tp == 1)
    it runs JAX's capacity dispatch with the experts sharded over `model`
    where the rules shard them: the router and the dispatch tables on
    every model rank over the replicated tokens, as on one device, each
    rank only its E/tp experts' slots, the parts psum'd through g (f on
    the tokens and gates, so training has its gradient); the shared
    experts column- and row-parallel as the MLP.  Its groups split over
    `data` when their count divides by dp (the aux's statistics averaged
    over the data ranks), else the tokens are gathered over `data` and
    dispatched as the whole batch's groups (a decode step: one group, the
    capacity of the step's B tokens, as JAX's), each rank keeping its
    rows.
An FSDP config (cfg.fsdp_embed) holds D / dp of every weight's `embed`
dim on a rank: given the layer's specs (`specs=`, from model.py),
`apply_block`, `prefill_block` and `decode_block` gather its weights over
`data` at their entry (models/fsdp), and the MoE FFN its experts, router
and shared expert (the all-to-all path inside moe_a2a, after the
dispatch; the capacity dispatch before the routing).
Where the rules map "seq" to `model` and tp divides the full S
(training and prefill; runtime/sharding.residual_seq_axis), the residual
is sharded on its sequence, as JAX's `shard(h, "residual")` lays it out:
a block takes and returns the rank's S/tp positions (Megatron's sequence
parallelism, models/sharding_hook).  The norms run on the slice (their
scales through f, `seq_shared`: each rank's part of their gradient
summed over `model`); attention and the sharded MLP gather the sequence
before their column-parallel products and psum-scatter it after their
row-parallel ones; the capacity dispatch gathers it before the routing,
which then runs on the whole groups as JAX's `moe_tokens` constraint
(batch only) implies, its expert parts psum-scattered in place of the
psum; the all-to-all path takes the rank's slice as it is.  So remat
keeps 1/tp of the replicated layout's residual a layer.  Decode (S = 1),
an S the axis does not divide, tp 1 and rules mapping "seq" to None keep
the residual replicated.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import attention as attn_mod
from repro_torch.models import fsdp
from repro_torch.models import sharding_hook as hook
from repro_torch.models.layers import (apply_mlp, apply_norm, dense_init, init_mlp, init_norm,
                                       mlp_axes, norm_axes)
from repro_torch.models.moe import _shared, apply_moe, init_moe, moe_axes, n_groups_for
from repro_torch.models.moe_a2a import apply_moe_a2a
from repro_torch.runtime import mesh as mesh_mod
from repro_torch.runtime.mesh import DATA_AXIS, MODEL_AXIS, POD_AXIS, pmean_value


def _init_attention_half(gen: torch.Generator, cfg, lead) -> dict:
    return {
        "norm1": init_norm(cfg.norm, cfg.d_model, cfg.dtype, gen.device, lead),
        "attn": attn_mod.init_attention(
            gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim,
            qk_norm=cfg.qk_norm, dtype=cfg.dtype, lead=lead,
        ),
        "norm2": init_norm(cfg.norm, cfg.d_model, cfg.dtype, gen.device, lead),
    }


def _attention_half_axes(cfg) -> dict:
    return {"norm1": norm_axes(cfg.norm), "attn": attn_mod.attention_axes(cfg.qk_norm),
            "norm2": norm_axes(cfg.norm)}


def block_axes(cfg) -> dict:
    """The logical axes of one init_block (no layer dim)."""
    p = _attention_half_axes(cfg)
    if cfg.n_experts:
        p["moe"] = moe_axes(cfg.n_shared_experts)
    else:
        p["mlp"] = mlp_axes(cfg.act)
    return p


def dense_block_axes(cfg) -> dict:
    return {**_attention_half_axes(cfg), "mlp": mlp_axes(cfg.act)}


def init_block(gen: torch.Generator, cfg, n: Optional[int]) -> dict:
    """Params of n decoder blocks stacked on a leading layer axis, or of one
    block without that axis when n is None (the hybrid family's weight-tied
    shared block): "moe" when cfg has experts, else "mlp"."""
    lead = () if n is None else (n,)
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


def _moe_ffn(moe_params: dict, f_in: torch.Tensor, cfg, n_groups: int,
             specs: Optional[dict] = None):
    """The MoE FFN (see the module's docstring); `specs`, where given, are
    the specs of the layer's FSDP-sharded MoE weights (models/fsdp), which
    the all-to-all path gathers after its dispatch and the capacity
    dispatch before its routing."""
    mesh = hook.current_mesh()
    if mesh is None:
        return apply_moe(moe_params, f_in, top_k=cfg.top_k, n_groups=n_groups,
                         capacity_factor=cfg.capacity_factor)
    tp = mesh.size(MODEL_AXIS)
    dp = mesh.size(POD_AXIS) * mesh.size(DATA_AXIS)
    seq = hook.seq_parallel()  # f_in is then the rank's slice of an S that tp divides
    d_ff = cfg.moe_d_ff or cfg.d_ff
    if tp > 1 and cfg.moe_impl == "a2a" and cfg.n_experts % tp == 0 and (
            seq or f_in.shape[1] % tp == 0):
        return apply_moe_a2a(mesh, moe_params, f_in, top_k=cfg.top_k, n_experts=cfg.n_experts,
                             capacity_factor=cfg.capacity_factor,
                             wire_dtype=cfg.moe_wire_dtype,
                             shared_ffn=cfg.n_shared_experts * d_ff or None,
                             specs=specs, seq_sharded=seq)
    moe_params = fsdp.gather_tree(moe_params, specs)
    # The capacity dispatch, with the experts the rules gave this rank (all
    # of them where E does not divide tp): the routing over the whole
    # sequence, replicated over `model` (gathered first where the residual
    # is sharded on it), each rank its experts' slots, their parts psum'd
    # (or psum-scattered to the rank's positions) over `model`.
    f_in = hook.seq_whole(f_in)
    b, s, _ = f_in.shape  # this data rank's rows: the global batch is b * dp
    routed = {k: v for k, v in moe_params.items() if k != "shared"}
    e_loc = routed["wi"].shape[-3]
    kw = dict(top_k=cfg.top_k, capacity_factor=cfg.capacity_factor,
              expert_lo=hook.model_index() * e_loc, enter=hook.enter_model)
    groups = n_groups_for(b * s * dp, n_groups)
    if groups % dp == 0:  # each data rank dispatches its own groups
        # the aux's statistics are the batch's: their mean over the data ranks
        out, aux = apply_moe(routed, f_in, n_groups=groups // dp, **kw,
                             stat_mean=lambda x: pmean_value(x, mesh, (POD_AXIS, DATA_AXIS)))
    else:  # one dispatch over the step's whole batch (a decode step: one group)
        whole = mesh_mod.all_gather(f_in, mesh, DATA_AXIS, 0)
        out, aux = apply_moe(routed, whole, n_groups=groups, **kw)
        out = out.narrow(0, mesh.index(DATA_AXIS) * b, b)
    out = hook.row_out(out) if e_loc != cfg.n_experts else hook.seq_part(out)
    if "shared" in moe_params:
        sp = moe_params["shared"]
        if sp["wo"].shape[-2] != cfg.n_shared_experts * d_ff:  # column- and row-parallel
            out = out + hook.row_out(_shared(sp, hook.enter_model(f_in)))
        else:
            out = out + hook.seq_part(_shared(sp, f_in))
    return out, aux


def _mlp(mlp_params: dict, f_in: torch.Tensor, cfg, d_ff: int) -> torch.Tensor:
    """The dense MLP; column- then row-parallel when its ffn is sharded."""
    if mlp_params["wo"].shape[-2] != d_ff:
        return hook.row_out(apply_mlp(mlp_params, hook.column_in(f_in), cfg.act))
    return hook.seq_part(apply_mlp(mlp_params, hook.seq_whole(f_in), cfg.act))


def _ffn(params: dict, h: torch.Tensor, cfg, n_groups: int,
         specs: Optional[dict]) -> Tuple[torch.Tensor, torch.Tensor]:
    f_in = apply_norm(cfg.norm, hook.seq_shared(params["norm2"]), h)
    if "moe" in params:
        moe_specs = None if specs is None else specs["moe"]
        f_out, aux = _moe_ffn(params["moe"], f_in, cfg, n_groups, specs=moe_specs)
    else:
        d_ff = (cfg.dense_d_ff or cfg.d_ff) if cfg.n_experts else cfg.d_ff
        f_out = _mlp(params["mlp"], f_in, cfg, d_ff)
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
    return h + f_out, aux


def apply_block(params: dict, h: torch.Tensor, positions: torch.Tensor, cfg, *,
                causal=None, specs: Optional[dict] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """One block over the full sequence, h (B, S, D) (the rank's S/tp
    positions where the residual is sharded on its sequence; positions are
    always the whole sequence's): (h, moe_aux).  With
    `specs` (an FSDP config on a mesh), the block's weights are gathered
    over `data` first (models/fsdp; an MoE layer's inside its FFN)."""
    causal = cfg.causal if causal is None else causal
    params = fsdp.gather_tree(params, specs, skip=("moe",))
    a_in = apply_norm(cfg.norm, hook.seq_shared(params["norm1"]), h)
    h = h + attn_mod.attention(
        params["attn"], a_in, positions,
        causal=causal, qk_norm=cfg.qk_norm, rope=True, rope_base=cfg.rope_base,
        impl=cfg.attn_impl, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
    )
    return _ffn(params, h, cfg, cfg.moe_groups, specs)


def prefill_block(params: dict, h: torch.Tensor, positions: torch.Tensor, cfg,
                  specs: Optional[dict] = None) -> Tuple[torch.Tensor, dict, torch.Tensor]:
    """apply_block that also emits this layer's KV cache: (h, kv, moe_aux)."""
    params = fsdp.gather_tree(params, specs, skip=("moe",))
    a_in = apply_norm(cfg.norm, hook.seq_shared(params["norm1"]), h)
    a_out, kv = attn_mod.prefill_attention(
        params["attn"], a_in, positions,
        causal=cfg.causal, qk_norm=cfg.qk_norm, rope=True, rope_base=cfg.rope_base,
        impl=cfg.attn_impl, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
    )
    h, aux = _ffn(params, h + a_out, cfg, cfg.moe_groups, specs)
    return h, kv, aux


def decode_block(params: dict, h: torch.Tensor, cache: dict, pos: int, cfg,
                 seq_sharded: bool = False,
                 specs: Optional[dict] = None) -> Tuple[torch.Tensor, dict, torch.Tensor]:
    """One decode step through a block, h (B, 1, D); the cache is updated
    in place (seq_sharded: the cache is sharded on its sequence over
    `model`).  The MoE FFN dispatches the step's B tokens as one group (on
    a mesh the whole step's, gathered over `data`).  Returns (h, cache,
    moe_aux)."""
    params = fsdp.gather_tree(params, specs, skip=("moe",))
    a_in = apply_norm(cfg.norm, hook.seq_shared(params["norm1"]), h)
    a_out, cache = attn_mod.decode_attention(
        params["attn"], a_in, cache, pos,
        qk_norm=cfg.qk_norm, rope=True, rope_base=cfg.rope_base,
        n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, seq_sharded=seq_sharded,
    )
    h, aux = _ffn(params, h + a_out, cfg, 1, specs)
    return h, cache, aux


# ---------------------------------------------------------------------------
# VLM projector (phi-3-vision stub front end)
# ---------------------------------------------------------------------------


def vlm_projector_axes() -> dict:
    return {"w1": (None, "embed"), "w2": ("embed", "embed_out")}


def init_vlm_projector(gen: torch.Generator, vision_dim: int, d_model: int,
                       dtype: torch.dtype) -> dict:
    return {
        "w1": dense_init(gen, (vision_dim, d_model), dtype, fan_in=vision_dim),
        "w2": dense_init(gen, (d_model, d_model), dtype, fan_in=d_model),
    }


def apply_vlm_projector(params: dict, img_embeds: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(B, n_img_tokens, vision_dim) precomputed CLIP features -> (B, n, D),
    in `dtype` (the tanh GELU, `jax.nn.gelu`'s default)."""
    h = F.gelu(img_embeds.to(dtype) @ params["w1"].to(dtype), approximate="tanh")
    return h @ params["w2"].to(dtype)


# ---------------------------------------------------------------------------
# Audio frame projection (hubert stub front end)
# ---------------------------------------------------------------------------


def frame_proj_axes() -> dict:
    return {"w": (None, "embed")}


def init_frame_proj(gen: torch.Generator, frame_dim: int, d_model: int,
                    dtype: torch.dtype) -> dict:
    return {"w": dense_init(gen, (frame_dim, d_model), dtype, fan_in=frame_dim)}


def apply_frame_proj(params: dict, features: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(B, T, frame_dim) precomputed frame features -> (B, T, D) in `dtype`."""
    return features.to(dtype) @ params["w"].to(dtype)
