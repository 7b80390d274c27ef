"""Architecture registry: --arch <id> resolves here.

Port of src/repro/configs/__init__.py, with the same ids and aliases.  Three
families are ported: dense (gemma_2b, olmo_1b, granite_8b, qwen3_32b),
xlstm (xlstm_1p3b) and moe (granite_moe_1b_a400m, kimi_k2_1t_a32b), each
config with CONFIG (the full configuration) and SMOKE (a reduced
same-family config for CPU tests), copied from the JAX package.  Asking for an architecture of a family not ported yet raises
NotImplementedError naming the ROADMAP slice that ports it.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List

from repro_torch.configs.base import ArchConfig

ARCH_IDS: List[str] = [
    "zamba2_1p2b",
    "qwen3_32b",
    "olmo_1b",
    "granite_8b",
    "gemma_2b",
    "phi3_vision_4p2b",
    "kimi_k2_1t_a32b",
    "granite_moe_1b_a400m",
    "xlstm_1p3b",
    "hubert_xlarge",
]

# CLI aliases (the assignment's dashed ids).
ALIASES: Dict[str, str] = {
    "zamba2-1.2b": "zamba2_1p2b",
    "qwen3-32b": "qwen3_32b",
    "olmo-1b": "olmo_1b",
    "granite-8b": "granite_8b",
    "gemma-2b": "gemma_2b",
    "phi-3-vision-4.2b": "phi3_vision_4p2b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "xlstm-1.3b": "xlstm_1p3b",
    "hubert-xlarge": "hubert_xlarge",
}

PORTED = ("qwen3_32b", "olmo_1b", "granite_8b", "gemma_2b", "xlstm_1p3b",
          "kimi_k2_1t_a32b", "granite_moe_1b_a400m")
PORTED_FAMILIES = ("dense", "xlstm", "moe")

# The ROADMAP section 1 slice that ports each remaining family, and the
# family of each architecture not ported yet.
FAMILY_SLICES: Dict[str, str] = {
    "hybrid": "the hybrid (Mamba2) slice",
    "vlm": "the VLM slice",
    "audio": "the audio-encoder slice",
}
NOT_PORTED: Dict[str, str] = {
    "zamba2_1p2b": "hybrid",
    "phi3_vision_4p2b": "vlm",
    "hubert_xlarge": "audio",
}


def not_ported(what: str, family: str) -> NotImplementedError:
    """The error for a family the port does not run yet."""
    return NotImplementedError(
        f"{what} ({family} family) is not ported yet (ROADMAP section 1, "
        f"{FAMILY_SLICES[family]}); the port runs the {', '.join(PORTED_FAMILIES)} "
        f"families: {', '.join(PORTED)}"
    )


def _module(arch: str):
    arch = ALIASES.get(arch, arch)
    if arch in NOT_PORTED:
        raise not_ported(arch, NOT_PORTED[arch])
    if arch not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{arch}")


def get_config(arch: str) -> ArchConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ArchConfig:
    return _module(arch).SMOKE


def cut_depth(cfg: ArchConfig, n_layers: int) -> ArchConfig:
    """cfg with n_layers layers and every width kept (the CLIs'
    `--n-layers`): an MoE config keeps its leading dense layers and needs
    one MoE layer after them, an xlstm config whole groups of slstm_every
    blocks.  Raises ValueError for a cut it cannot make."""
    if n_layers < 1 or n_layers > cfg.n_layers:
        raise ValueError(f"--n-layers {n_layers}: {cfg.name} has {cfg.n_layers} layers")
    if cfg.family == "moe" and n_layers <= cfg.first_dense:
        raise ValueError(f"--n-layers {n_layers}: {cfg.name} has {cfg.first_dense} dense "
                         f"layers first; keep at least one MoE layer after them")
    if cfg.family == "xlstm" and n_layers % cfg.slstm_every:
        raise ValueError(f"--n-layers {n_layers}: xlstm keeps whole groups of "
                         f"{cfg.slstm_every} blocks")
    return dataclasses.replace(cfg, n_layers=n_layers)
