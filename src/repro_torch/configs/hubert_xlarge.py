"""hubert-xlarge [audio]: encoder-only 48L d1280 16H d_ff 5120, 504 cluster
targets (arXiv:2106.07447). Conv waveform frontend is a STUB — input_specs
feeds precomputed frame features (B, T, 512). No decode shapes."""

import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    d_ff=5120,
    vocab=504,
    act="gelu",
    causal=False,
    tie_embeddings=False,
    frame_dim=512,
    decode_supported=False,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
    vocab=32, frame_dim=16, compute_dtype="float32", attn_block=32,
)
