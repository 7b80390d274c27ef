"""Carry weights and configurations across from the JAX package.

The JAX engine keeps the dictionary as one (M, K) array, atom-sharded by
columns; the port keeps contiguous (N, M, Kb) blocks, agent n owning
columns [n*Kb, (n+1)*Kb) as in the JAX `blocks_from_full`.  The LM params
keep the JAX layouts and nesting.  These helpers take plain numpy arrays
and keyword fields, so neither package imports the other.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.baselines import MairalState
from repro_torch.core.dictionary import blocks_from_full, full_from_blocks
from repro_torch.core.distributed import DistConfig
from repro_torch.core.learner import LearnerState
from repro_torch.core.topology import LevelSpec
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.model import require_ported, tree_map

# JAX DistConfig fields that do not change what the coder computes on one
# device: the mesh axis names and the Pallas switches.
_JAX_ONLY_FIELDS = frozenset({
    "model_axis", "data_axes", "pod_axis", "use_kernel", "kernel_interpret",
})


def dictionary_from_numpy(W: np.ndarray, n_agents: int, device: DeviceLike = "cuda") -> torch.Tensor:
    """(M, K) numpy dictionary -> the port's contiguous (N, M, Kb) blocks."""
    W = np.asarray(W)
    if W.ndim != 2:
        raise ValueError(f"W must be (M, K), got shape {W.shape}")
    return blocks_from_full(torch.from_numpy(W).to(resolve_device(device)), n_agents)


def dictionary_to_numpy(blocks: torch.Tensor) -> np.ndarray:
    """Inverse of dictionary_from_numpy: (N, M, Kb) blocks -> (M, K) numpy."""
    return full_from_blocks(blocks).cpu().numpy()


def learner_state_from_numpy(W: np.ndarray, A: np.ndarray, informed: np.ndarray, step: int,
                             n_agents: int, device: DeviceLike = "cuda") -> LearnerState:
    """A DictionaryLearner state from numpy: the (M, K) dictionary W (JAX
    `learner.dictionary(state)`), the (N, N) combiner A, the (N,) informed
    mask and the step count."""
    dev = resolve_device(device)
    return LearnerState(
        W_blocks=dictionary_from_numpy(W, n_agents, dev), step=int(step),
        A=torch.as_tensor(np.asarray(A, np.float32), device=dev),
        informed=torch.as_tensor(np.asarray(informed, np.float32), device=dev),
    )


def mairal_state_from_numpy(W: np.ndarray, A: np.ndarray, B: np.ndarray, t: int,
                            device: DeviceLike = "cuda") -> MairalState:
    """A MairalLearner state from numpy: W (M, K) and the statistics
    A (K, K) and B (M, K), and the step count t."""
    dev = resolve_device(device)
    return MairalState(*(torch.as_tensor(np.asarray(a, np.float32), device=dev)
                         for a in (W, A, B)), t=int(t))


def _level_spec(level) -> LevelSpec:
    """A port LevelSpec from a JAX one, or from its field dict (what
    `dataclasses.asdict` of a JAX DistConfig holds)."""
    if not isinstance(level, dict):
        level = {f.name: getattr(level, f.name) for f in dataclasses.fields(LevelSpec)}
    return LevelSpec(**level)


def dist_config_from_jax_fields(**fields) -> DistConfig:
    """A port DistConfig from JAX DistConfig field names (for instance
    `**dataclasses.asdict(jax_cfg)`).  Fields the port has are carried over
    (`levels` given as LevelSpecs or their dicts); the JAX-only ones listed
    above are dropped; any other name raises."""
    ported = {f.name for f in dataclasses.fields(DistConfig)}
    unknown = set(fields) - ported - _JAX_ONLY_FIELDS
    if unknown:
        raise TypeError(f"not DistConfig fields: {sorted(unknown)}")
    kept = {k: v for k, v in fields.items() if k in ported}
    if not isinstance(kept.get("levels", ""), str):
        kept["levels"] = tuple(_level_spec(lv) for lv in kept["levels"])
    return DistConfig(**kept)


def lm_params_from_numpy(cfg, tree: dict, device: DeviceLike = "cuda") -> dict:
    """The port's LM params from the JAX value tree mapped to numpy
    (`split_tree(M.init(cfg, key))[0]`, every leaf `np.asarray`).

    Both sides hold each stack's tensors on a leading layer axis and use one
    layout.  Dense: wq/wk/wv (L, D, H, Dh), wo (L, H, Dh, D), the MLP
    matrices (L, fan_in, fan_out).  xlstm: "mlstm" and "slstm" stacks, the
    projections (fan_in, fan_out), the block-diagonal q/k/v and the sLSTM's
    r_* (L, H, P, P) indexed (in, out).  One embedding table (V, D) that the
    tied unembedding reads transposed.  So every leaf crosses as it is, in
    cfg.param_dtype, onto `device`; the nesting is kept, empty dicts (the
    nonparametric norms) included.  Families not ported raise."""
    require_ported(cfg)
    dev = resolve_device(device)
    return tree_map(
        lambda a: torch.from_numpy(np.array(a, dtype=np.float32)).to(dev, cfg.dtype), tree
    )
