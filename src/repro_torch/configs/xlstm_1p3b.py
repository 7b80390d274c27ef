"""xlstm-1.3b [ssm]: 48 blocks d2048 4H; mLSTM blocks with every 8th an
sLSTM block (7:1 per arXiv:2405.04517). No separate FFN (d_ff=0 — the
projections live inside the blocks)."""

import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-1.3b",
    family="xlstm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab=50304,
    slstm_every=8,
    mlstm_proj_factor=2,
    sub_quadratic=True,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=4, d_model=64, n_heads=2, n_kv_heads=2, vocab=256,
    slstm_every=2, compute_dtype="float32", ssm_chunk=16,
)
