"""granite-moe-1b-a400m [moe]: 24L d1024 16H GQA kv=8, 32 experts top-8,
per-expert d_ff 512 (hf:ibm-granite/granite-3.0-1b-a400m-base)."""

import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=512,
    vocab=49155,
    act="swiglu",
    n_experts=32,
    top_k=8,
    moe_d_ff=512,
    moe_impl="a2a",  # the JAX package's expert-parallel path; one card dispatches by capacity
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=32,
    vocab=256, n_experts=8, top_k=2, moe_d_ff=32,
    compute_dtype="float32", attn_block=32, moe_groups=2,
)
