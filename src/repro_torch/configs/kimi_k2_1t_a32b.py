"""kimi-k2-1t-a32b [moe]: 61L d7168 64H GQA kv=8, MoE 384 experts top-8 with
per-expert d_ff 2048, 1 shared expert, first layer dense (DeepSeek-V3-style).
Trillion-param class: bf16 params + Adafactor (optim.for_arch)."""

import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    d_ff=2048,          # per-expert hidden dim (paper-table spec)
    vocab=163840,
    head_dim=112,
    act="swiglu",
    n_experts=384,
    top_k=8,
    moe_d_ff=2048,
    n_shared_experts=1,
    first_dense=1,
    dense_d_ff=18432,
    moe_impl="a2a",     # the JAX package's expert-parallel path; one card dispatches by capacity
    moe_wire_dtype="int8",  # the expert-parallel path's q8 wire (unused on one card)
    param_dtype="bfloat16",
    fsdp_embed=True,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=3, d_model=64, n_heads=4, n_kv_heads=2, d_ff=32,
    vocab=256, head_dim=16, n_experts=8, top_k=2, moe_d_ff=32,
    n_shared_experts=1, first_dense=1, dense_d_ff=128,
    param_dtype="float32", compute_dtype="float32", attn_block=32,
    moe_groups=2, fsdp_embed=False,
)
