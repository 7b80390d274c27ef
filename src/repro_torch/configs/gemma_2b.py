"""gemma-2b [dense]: 18L d2048 8H MQA kv=1 d_ff 16384, GeGLU, head_dim=256,
embeddings scaled by sqrt(d) (arXiv:2403.08295)."""

import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma-2b",
    family="dense",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    d_ff=16384,
    vocab=256000,
    head_dim=256,
    act="geglu",
    embed_scale=True,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=1, d_ff=128,
    vocab=256, head_dim=16, compute_dtype="float32", attn_block=32,
)
