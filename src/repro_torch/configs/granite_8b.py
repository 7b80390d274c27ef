"""granite-8b [dense]: 36L d4096 32H GQA kv=8 d_ff 14336, llama-arch
(arXiv:2405.04324)."""

import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-8b",
    family="dense",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=49152,
    act="swiglu",
    fsdp_embed=True,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab=256, compute_dtype="float32", attn_block=32, fsdp_embed=False,
)
