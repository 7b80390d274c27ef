"""Model assembly for the dense LM family: ArchConfig -> init / forward /
prefill / decode.

Port of the dense-family part of src/repro/models/model.py (qwen3, olmo,
granite, gemma: a pre-norm decoder stack).  Params are a dict tree in the
JAX package's layouts, every layer's tensors stacked on a leading layer
axis (what the JAX side scans over); the port walks the layers with a
Python loop.  Every entry point first brings the params into the form it
walks (`cast_params`): float tensors in the compute dtype, as the JAX
`_cast_params` does, and the stacked layers split into a list of
per-layer views.  A tree already in that form passes through untouched,
so a server prepares it once and its decode loop does no per-step tree
work.  The decode cache is updated in place (JAX returns a new one).

The other families (moe, hybrid, xlstm, vlm, audio) raise, naming their
ROADMAP slice; the loss and training wait for the training slice.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from repro_torch.configs import not_ported
from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import apply_norm, embed, init_embedding, init_norm, unembed


def require_dense(cfg: ArchConfig) -> None:
    """Raise for what the port does not run: other families, untied heads."""
    if cfg.family != "dense":
        raise not_ported(cfg.name, cfg.family)
    if not cfg.tie_embeddings:
        raise NotImplementedError(f"{cfg.name}: untied output heads are not ported "
                                  f"(every dense config ties its embeddings)")


def tree_map(fn: Callable[[torch.Tensor], torch.Tensor], tree: dict) -> dict:
    """fn over every tensor of a nested dict."""
    return {k: tree_map(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def cast_params(cfg: ArchConfig, params: dict) -> dict:
    """The params as the entry points walk them: float tensors in the
    compute dtype, params["layers"] a list of per-layer trees (views of the
    stacked tensors).  A tree already in that form is returned as it is."""
    if isinstance(params["layers"], list):
        return params
    cdt = cfg.cdtype
    cast = tree_map(lambda t: t.to(cdt) if t.is_floating_point() else t, params)
    stacked = cast["layers"]
    cast["layers"] = [tree_map(lambda t: t[i], stacked) for i in range(cfg.n_layers)]
    return cast


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def init(cfg: ArchConfig, seed: int = 0, device: DeviceLike = "cuda") -> Dict[str, dict]:
    """Random params from `seed`, in cfg.param_dtype, on `device` (the card
    unless the CPU is asked for)."""
    require_dense(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return {
        "embed": init_embedding(gen, cfg.vocab, cfg.d_model, cfg.dtype),
        "layers": tfm.init_block(gen, cfg, cfg.n_layers),
        "final_norm": init_norm(cfg.norm, cfg.d_model, cfg.dtype, dev),
    }


# ---------------------------------------------------------------------------
# Embedding front-end and logits
# ---------------------------------------------------------------------------


def _embed_inputs(cfg: ArchConfig, params: dict, tokens: torch.Tensor) -> torch.Tensor:
    table = params["embed"]["table"]
    tokens = torch.as_tensor(tokens, device=table.device).long()
    return embed(params["embed"], tokens, scale_by_dim=cfg.embed_scale).to(cfg.cdtype)


def _logits(cfg: ArchConfig, params: dict, h: torch.Tensor) -> torch.Tensor:
    return unembed(params["embed"], apply_norm(cfg.norm, params["final_norm"], h))


# ---------------------------------------------------------------------------
# Forward, prefill, decode
# ---------------------------------------------------------------------------


def forward(cfg: ArchConfig, params: dict, batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (logits (B, S, V) fp32, moe_aux scalar: 0 for a dense stack)."""
    require_dense(cfg)
    params = cast_params(cfg, params)
    h = _embed_inputs(cfg, params, batch["tokens"])
    positions = torch.arange(h.shape[1], device=h.device)
    for i in range(cfg.n_layers):
        h = tfm.apply_block(params["layers"][i], h, positions, cfg)
    return _logits(cfg, params, h), torch.zeros((), device=h.device)


def init_cache(cfg: ArchConfig, batch: int, max_len: int, device: DeviceLike = "cuda") -> dict:
    """Zero decode cache: {"layers": {"k", "v": (L, B, max_len, Hkv, Dh)}}
    in the compute dtype."""
    require_dense(cfg)
    return {"layers": attn_mod.init_cache(
        batch, max_len, cfg.n_kv_heads, cfg.resolved_head_dim, cfg.cdtype,
        resolve_device(device), lead=(cfg.n_layers,),
    )}


def prefill(cfg: ArchConfig, params: dict, batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, dict]:
    """Full-sequence forward that also returns the decode cache of the
    prompt: (logits (B, S, V) fp32, {"layers": {"k", "v": (L, B, S, Hkv, Dh)}})."""
    require_dense(cfg)
    params = cast_params(cfg, params)
    h = _embed_inputs(cfg, params, batch["tokens"])
    positions = torch.arange(h.shape[1], device=h.device)
    ks, vs = [], []
    for i in range(cfg.n_layers):
        h, kv = tfm.prefill_block(params["layers"][i], h, positions, cfg)
        ks.append(kv["k"])
        vs.append(kv["v"])
    return _logits(cfg, params, h), {"layers": {"k": torch.stack(ks), "v": torch.stack(vs)}}


def decode_step(
    cfg: ArchConfig,
    params: dict,
    cache: dict,
    tokens: torch.Tensor,  # (B, 1)
    pos: int,  # current position (write index)
) -> Tuple[torch.Tensor, dict]:
    """Returns (logits (B, 1, V) fp32, the cache, updated in place)."""
    require_dense(cfg)
    params = cast_params(cfg, params)
    h = _embed_inputs(cfg, params, tokens)
    layers = cache["layers"]
    for i in range(cfg.n_layers):
        layer_cache = {"k": layers["k"][i], "v": layers["v"][i]}
        h, _ = tfm.decode_block(params["layers"][i], h, layer_cache, pos, cfg)
    return _logits(cfg, params, h), cache
