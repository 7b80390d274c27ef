"""Architecture registry: --arch <id> resolves here.

Port of src/repro/configs/__init__.py, with the same ids and aliases.  Two
families are ported: dense (gemma_2b, olmo_1b, granite_8b, qwen3_32b) and
xlstm (xlstm_1p3b), each config with CONFIG (the full configuration) and
SMOKE (a reduced same-family config for CPU tests), copied from the JAX
package.  Asking for an architecture of a family not ported yet raises
NotImplementedError naming the ROADMAP slice that ports it.
"""

from __future__ import annotations

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

PORTED = ("qwen3_32b", "olmo_1b", "granite_8b", "gemma_2b", "xlstm_1p3b")
PORTED_FAMILIES = ("dense", "xlstm")

# The ROADMAP section 1 slice that ports each remaining family, and the
# family of each architecture not ported yet.
FAMILY_SLICES: Dict[str, str] = {
    "moe": "the MoE slice",
    "hybrid": "the hybrid (Mamba2) slice",
    "vlm": "the VLM slice",
    "audio": "the audio-encoder slice",
}
NOT_PORTED: Dict[str, str] = {
    "zamba2_1p2b": "hybrid",
    "phi3_vision_4p2b": "vlm",
    "kimi_k2_1t_a32b": "moe",
    "granite_moe_1b_a400m": "moe",
    "hubert_xlarge": "audio",
}


def not_ported(what: str, family: str) -> NotImplementedError:
    """The error for a family the port does not run yet."""
    return NotImplementedError(
        f"{what} ({family} family) is not ported yet (ROADMAP section 1, "
        f"{FAMILY_SLICES[family]}); the port runs the {' and '.join(PORTED_FAMILIES)} "
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
