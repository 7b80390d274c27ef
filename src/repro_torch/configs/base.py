"""ArchConfig: one dataclass describes every architecture of the LM zoo.

Port of the `ArchConfig` of src/repro/configs/base.py (copied, field for
field, so a config module reads the same on both sides), with `dtype` and
`cdtype` returning torch dtypes.  The JAX side's shape registry and
`input_specs` (ShapeDtypeStructs for its dry-run) have no counterpart here.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | hybrid | xlstm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    act: str = "swiglu"
    norm: str = "rms"  # rms | nonparametric
    qk_norm: bool = False
    embed_scale: bool = False  # gemma: scale embeddings by sqrt(d)
    rope_base: float = 10000.0
    causal: bool = True  # False => encoder-only (hubert)
    tie_embeddings: bool = True
    # -- MoE ----------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0  # per-expert hidden dim (d_ff used if 0)
    n_shared_experts: int = 0
    first_dense: int = 0  # first k layers dense instead of MoE
    dense_d_ff: int = 0  # d_ff of those dense layers
    capacity_factor: float = 1.25
    moe_groups: int = 16  # dispatch groups (aligned with data shards)
    moe_impl: str = "gather"  # gather (GSPMD capacity dispatch) | a2a (EP)
    moe_wire_dtype: str = "native"  # native | int8 (q8 FSDP gathers + dispatch)
    # -- SSM / hybrid (zamba2) -----------------------------------------------
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    attn_every: int = 0  # shared attn block after every k-th mamba block
    # -- xLSTM ----------------------------------------------------------------
    slstm_every: int = 0  # every k-th block is sLSTM
    mlstm_proj_factor: int = 2
    # -- VLM (phi-3-vision) ----------------------------------------------------
    n_img_tokens: int = 0
    vision_dim: int = 0
    # -- audio (hubert) ---------------------------------------------------------
    frame_dim: int = 0
    mask_frac: float = 0.08  # masked-prediction training
    # -- numerics ----------------------------------------------------------------
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    # -- runtime knobs -------------------------------------------------------------
    remat: bool = True
    scan_layers: bool = True
    attn_impl: str = "blockwise"  # blockwise | dense | pallas
    attn_block: int = 512
    ssm_chunk: int = 128
    fsdp_embed: bool = False  # shard the `embed` logical axis over `data`
    # -- capability flags ------------------------------------------------------------
    sub_quadratic: bool = False  # can run long_500k
    decode_supported: bool = True  # False for encoder-only

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def cdtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    # -- parameter count (for roofline MODEL_FLOPS) ---------------------------

    def param_counts(self) -> Dict[str, int]:
        """Returns {"total": N, "active": N_active} (active differs for MoE)."""
        d, v, L = self.d_model, self.vocab, self.n_layers
        hd = self.resolved_head_dim
        emb = v * d
        att = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) + self.n_heads * hd * d

        def mlp_p(dff: int) -> int:
            mats = 3 if self.act in ("swiglu", "geglu") else 2
            return mats * d * dff

        total = emb
        active = emb
        if self.family in ("dense", "vlm", "audio"):
            per = att + mlp_p(self.d_ff)
            total += L * per
            active += L * per
        elif self.family == "moe":
            dff_e = self.moe_d_ff or self.d_ff
            n_moe = L - self.first_dense
            router = d * self.n_experts
            expert = mlp_p(dff_e)
            shared = mlp_p(self.n_shared_experts * dff_e) if self.n_shared_experts else 0
            total += L * att + self.first_dense * mlp_p(self.dense_d_ff or self.d_ff)
            total += n_moe * (router + self.n_experts * expert + shared)
            active += L * att + self.first_dense * mlp_p(self.dense_d_ff or self.d_ff)
            active += n_moe * (router + self.top_k * expert + shared)
        elif self.family == "hybrid":
            d_inner = self.ssm_expand * d
            nst = self.ssm_state
            nh = d_inner // self.ssm_head_dim
            mamba = (
                d * (2 * d_inner + 2 * nst + nh)  # in_proj
                + 4 * (d_inner + 2 * nst)  # conv
                + 3 * nh + d_inner  # dt_bias, A, D, norm
                + d_inner * d  # out_proj
            )
            shared = att + mlp_p(self.d_ff)
            total += L * mamba + shared
            active += L * mamba + shared * max(1, L // max(self.attn_every, 1))
        elif self.family == "xlstm":
            di = self.mlstm_proj_factor * d
            # q/k/v are block-diagonal per head: 3 * H * (di/H)^2 = 3*di^2/H
            mlstm = 2 * d * di + 4 * di + 3 * di * di // self.n_heads + 2 * di * self.n_heads + di * d
            p = d // self.n_heads
            slstm = 4 * (d * d + self.n_heads * p * p + d)
            n_s = L // self.slstm_every if self.slstm_every else 0
            n_m = L - n_s
            total += n_m * mlstm + n_s * slstm
            active = total
        if self.family == "vlm":
            total += self.vision_dim * d + d * d  # projector
            active = total
        if self.family == "audio":
            total += self.frame_dim * d  # frame proj
            active = total
        return {"total": int(total), "active": int(active)}
