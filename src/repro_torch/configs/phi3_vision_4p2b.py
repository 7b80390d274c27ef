"""phi-3-vision-4.2b [vlm]: phi3-mini backbone (32L d3072 32H kv=32
d_ff 8192) + CLIP frontend STUB — input_specs feeds precomputed patch
embeddings (B, 576, 1024) through a 2-layer projector."""

import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab=32064,
    act="swiglu",
    n_img_tokens=576,
    vision_dim=1024,
    fsdp_embed=True,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
    vocab=256, n_img_tokens=8, vision_dim=32, compute_dtype="float32",
    attn_block=32, fsdp_embed=False,
)
