"""zamba2-1.2b [hybrid]: 38 Mamba2 layers + weight-tied shared attention
block every 6 layers (arXiv:2411.15242). ssm_state=64."""

import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab=32000,
    head_dim=64,
    act="swiglu",
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    attn_every=6,
    sub_quadratic=True,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
    vocab=256, head_dim=16, ssm_state=8, ssm_head_dim=16, attn_every=2,
    compute_dtype="float32", ssm_chunk=16, attn_block=32,
)
