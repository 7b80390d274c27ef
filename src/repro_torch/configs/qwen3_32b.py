"""qwen3-32b [dense]: 64L d5120 64H GQA kv=8 d_ff 25600, qk-norm."""

import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=64,
    n_kv_heads=8,
    d_ff=25600,
    vocab=151936,
    head_dim=128,
    act="swiglu",
    qk_norm=True,
    fsdp_embed=True,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab=256, head_dim=16, compute_dtype="float32", attn_block=32,
    fsdp_embed=False,
)
