"""olmo-1b [dense]: 16L d2048 16H kv=16 d_ff 8192, non-parametric LN
(arXiv:2402.00838)."""

import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="olmo-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab=50304,
    act="swiglu",
    norm="nonparametric",
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
    vocab=256, compute_dtype="float32", attn_block=32,
)
