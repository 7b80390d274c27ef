"""Model assembly for the ported LM families: ArchConfig -> init / forward /
prefill / decode.

Port of the dense, moe and xlstm parts of src/repro/models/model.py:
  dense   a pre-norm decoder stack (qwen3, olmo, granite, gemma);
  moe     the same stack with the MoE FFN (models/moe.py), after
          `first_dense` leading dense blocks (kimi's first layer);
  xlstm   groups of (slstm_every - 1) pre-norm mLSTM blocks followed by one
          pre-norm sLSTM block, whose recurrence is one K3 launch
          (models/xlstm.py).
Params are a dict tree in the JAX package's layouts, every stack's
tensors stacked on a leading layer axis (what the JAX side scans over:
"layers" for dense; "dense_layers", over first_dense blocks when it is
set, and "layers", over the rest, for moe; "mlstm", over n_groups *
(slstm_every - 1) blocks, and "slstm", over n_groups, for xlstm); the port
walks the layers with a Python loop.  Every entry point first brings the
params into the form it walks (`cast_params`): float tensors in the
compute dtype (the MoE router too: `apply_moe` widens it to fp32), as
the JAX `_cast_params` does, and each stack split into a list of
per-layer views.
A tree already in that form passes through untouched, so a server
prepares it once and its decode loop does no per-step tree work.  The
decode cache is updated in place (JAX returns a new one).

The cast runs inside the autograd graph, so the gradient of a loss reaches
the fp32 master params through it, and each stack splits with
`torch.unbind` (whose backward writes one stacked gradient, where the
backward of one `select` per layer would write a zero-filled copy of the
whole stack per layer).  When grad flows and `cfg.remat` is set, each
transformer layer runs under `torch.utils.checkpoint` (non-reentrant): only its
input is kept, and its forward runs again in the backward, as the JAX
`_maybe_remat` with `nothing_saveable`; its K2 launch then runs twice.

`forward` returns the MoE load-balance aux summed over every layer (dense
layers first; 0 without experts), and `loss_fn` is the masked fp32
next-token cross-entropy plus 0.01 x that aux.  The other families
(hybrid, vlm, audio) raise, naming their ROADMAP slice; xlstm trains with
the xLSTM-training item (K3's gradient).
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs import PORTED_FAMILIES, not_ported
from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import transformer as tfm
from repro_torch.models import xlstm as xlstm_mod
from repro_torch.models.layers import apply_norm, embed, init_embedding, init_norm, unembed


def require_ported(cfg: ArchConfig) -> None:
    """Raise for what the port does not run: other families, untied heads."""
    if cfg.family not in PORTED_FAMILIES:
        raise not_ported(cfg.name, cfg.family)
    if not cfg.tie_embeddings:
        raise NotImplementedError(f"{cfg.name}: untied output heads are not ported "
                                  f"(every dense, moe and xlstm config ties its embeddings)")
    if cfg.family == "xlstm" and (not cfg.slstm_every or cfg.n_layers % cfg.slstm_every):
        raise ValueError(f"{cfg.name}: xlstm expects n_layers % slstm_every == 0")


def stack_sizes(cfg: ArchConfig) -> Dict[str, int]:
    """The layer stacks of the family and their depths."""
    if cfg.family == "xlstm":
        n_groups = cfg.n_layers // cfg.slstm_every
        return {"mlstm": n_groups * (cfg.slstm_every - 1), "slstm": n_groups}
    if cfg.family == "moe" and cfg.first_dense:
        return {"dense_layers": cfg.first_dense, "layers": cfg.n_layers - cfg.first_dense}
    return {"layers": cfg.n_layers}


def tree_map(fn: Callable[[torch.Tensor], torch.Tensor], tree: dict) -> dict:
    """fn over every tensor of a nested dict."""
    return {k: tree_map(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def cast_params(cfg: ArchConfig, params: dict) -> dict:
    """The params as the entry points walk them: float tensors in the
    compute dtype, each layer stack a list of per-layer trees (views of the
    stacked tensors).  A tree already in that form is returned as it is."""
    sizes = stack_sizes(cfg)
    if all(isinstance(params[key], list) for key in sizes):
        return params
    cdt = cfg.cdtype
    cast = tree_map(lambda t: t.to(cdt) if t.is_floating_point() else t, params)
    for key, n in sizes.items():
        split = tree_map(lambda t: t.unbind(0), cast[key])
        cast[key] = [_select(split, i) for i in range(n)]
    return cast


def _select(tree: dict, i: int) -> dict:
    """Entry i of every tuple of a tree of tuples."""
    return {k: _select(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


def require_trainable(cfg: ArchConfig) -> None:
    """Raise for a family the port cannot train yet, naming its item."""
    require_ported(cfg)
    if cfg.family == "xlstm":
        raise NotImplementedError(
            f"{cfg.name}: xlstm training is not ported yet (ROADMAP section 1, the "
            f"xLSTM-training item: K3 has no gradient); the port trains the dense family"
        )


def _needs_grad(*trees) -> bool:
    """Whether grad is enabled and any tensor of the trees requires it."""
    if not torch.is_grad_enabled():
        return False
    stack = list(trees)
    while stack:
        t = stack.pop()
        if isinstance(t, dict):
            stack.extend(t.values())
        elif isinstance(t, torch.Tensor) and t.requires_grad:
            return True
    return False


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def init(cfg: ArchConfig, seed: int = 0, device: DeviceLike = "cuda") -> Dict[str, dict]:
    """Random params from `seed`, in cfg.param_dtype, on `device` (the card
    unless the CPU is asked for)."""
    require_ported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = {"embed": init_embedding(gen, cfg.vocab, cfg.d_model, cfg.dtype)}
    if cfg.family == "xlstm":
        sizes = stack_sizes(cfg)
        lead_m, lead_s = (sizes["mlstm"],), (sizes["slstm"],)
        params["mlstm"] = {
            "norm": init_norm(cfg.norm, cfg.d_model, cfg.dtype, dev, lead_m),
            "mixer": xlstm_mod.init_mlstm(gen, cfg.d_model, cfg.n_heads,
                                          proj_factor=cfg.mlstm_proj_factor,
                                          dtype=cfg.dtype, lead=lead_m),
        }
        params["slstm"] = {
            "norm": init_norm(cfg.norm, cfg.d_model, cfg.dtype, dev, lead_s),
            "mixer": xlstm_mod.init_slstm(gen, cfg.d_model, cfg.n_heads, dtype=cfg.dtype,
                                          lead=lead_s),
        }
    else:
        sizes = stack_sizes(cfg)
        if "dense_layers" in sizes:
            params["dense_layers"] = tfm.init_dense_block(gen, cfg, sizes["dense_layers"])
        params["layers"] = tfm.init_block(gen, cfg, sizes["layers"])
    params["final_norm"] = init_norm(cfg.norm, cfg.d_model, cfg.dtype, dev)
    return params


# ---------------------------------------------------------------------------
# Embedding front-end and logits
# ---------------------------------------------------------------------------


def _embed_inputs(cfg: ArchConfig, params: dict, tokens: torch.Tensor) -> torch.Tensor:
    table = params["embed"]["table"]
    tokens = torch.as_tensor(tokens, device=table.device).long()
    return embed(params["embed"], tokens, scale_by_dim=cfg.embed_scale).to(cfg.cdtype)


def _logits(cfg: ArchConfig, params: dict, h: torch.Tensor) -> torch.Tensor:
    return unembed(params["embed"], apply_norm(cfg.norm, params["final_norm"], h))


def _blocks(cfg: ArchConfig, params: dict):
    """The transformer blocks' params in order: the dense layers first."""
    return params.get("dense_layers", []) + params["layers"]


def _xlstm_layers(cfg: ArchConfig, params: dict):
    """The xlstm blocks in order: (kind, group, index in group, layer params),
    kind "mlstm" (index 0 .. slstm_every - 2) or "slstm" (index 0)."""
    per = cfg.slstm_every - 1
    for gi in range(cfg.n_layers // cfg.slstm_every):
        for li in range(per):
            yield "mlstm", gi, li, params["mlstm"][gi * per + li]
        yield "slstm", gi, 0, params["slstm"][gi]


def _xlstm_mixer(cfg: ArchConfig, kind: str, lp: dict, h: torch.Tensor, return_cache: bool):
    h_in = apply_norm(cfg.norm, lp["norm"], h)
    if kind == "mlstm":
        return xlstm_mod.mlstm_block(lp["mixer"], h_in, n_heads=cfg.n_heads,
                                     proj_factor=cfg.mlstm_proj_factor, chunk=cfg.ssm_chunk,
                                     return_cache=return_cache)
    return xlstm_mod.slstm_block(lp["mixer"], h_in, n_heads=cfg.n_heads,
                                 return_cache=return_cache)


# ---------------------------------------------------------------------------
# Forward, prefill, decode
# ---------------------------------------------------------------------------


def forward(cfg: ArchConfig, params: dict, batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (logits (B, S, V) fp32, moe_aux scalar: 0 without experts)."""
    require_ported(cfg)
    params = cast_params(cfg, params)
    h = _embed_inputs(cfg, params, batch["tokens"])
    if cfg.family == "xlstm":
        for kind, _, _, lp in _xlstm_layers(cfg, params):
            h = h + _xlstm_mixer(cfg, kind, lp, h, return_cache=False)
        return _logits(cfg, params, h), torch.zeros((), device=h.device)
    positions = torch.arange(h.shape[1], device=h.device)
    aux_total = torch.zeros((), device=h.device)
    for lp in _blocks(cfg, params):
        if cfg.remat and _needs_grad(lp, h):
            h, aux = checkpoint(tfm.apply_block, lp, h, positions, cfg, use_reentrant=False)
        else:
            h, aux = tfm.apply_block(lp, h, positions, cfg)
        aux_total = aux_total + aux
    return _logits(cfg, params, h), aux_total


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------


def _ce(logits: torch.Tensor, targets: torch.Tensor,
        mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked mean cross-entropy in fp32. Returns (loss, n_tokens)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    nll = (lse - gold) * mask
    n = torch.clamp(torch.sum(mask), min=1.0)
    return torch.sum(nll) / n, n


def loss_fn(cfg: ArchConfig, params: dict,
            batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross-entropy of logits[:, :-1] against tokens[:, 1:] (all
    positions count) plus 0.01 x moe_aux (0 for dense): (total, {"ce",
    "moe_aux", "n_tokens"})."""
    require_trainable(cfg)
    logits, aux = forward(cfg, params, batch)
    tokens = torch.as_tensor(batch["tokens"], device=logits.device).long()
    mask = torch.ones(tokens[:, 1:].shape, dtype=torch.float32, device=logits.device)
    loss, n = _ce(logits[:, :-1, :], tokens[:, 1:], mask)
    total = loss + 0.01 * aux
    return total, {"ce": loss, "moe_aux": aux, "n_tokens": n}


# The cache entry of each transformer layer stack (JAX's names).
_CACHE_KEY = {"dense_layers": "dense", "layers": "layers"}


def init_cache(cfg: ArchConfig, batch: int, max_len: int, device: DeviceLike = "cuda") -> dict:
    """The decode cache, zero but for the stabilizers m (-1e30).  Dense and
    moe: {"layers": {"k", "v": (L, B, max_len, Hkv, Dh)}} in the compute
    dtype; moe with first_dense: {"dense": the first_dense layers' cache,
    "layers": the rest's}.
    xlstm (state caches; max_len unused): {"mlstm": {"conv_buf" (compute
    dtype), "C", "n", "m" (fp32)}, each (n_groups, slstm_every - 1, B, ...),
    "slstm": {"h", "c", "n", "m"}, each (n_groups, B, D) fp32}."""
    require_ported(cfg)
    dev = resolve_device(device)
    if cfg.family == "xlstm":
        n_groups = cfg.n_layers // cfg.slstm_every
        return {
            "mlstm": xlstm_mod.init_mlstm_cache(
                batch, cfg.d_model, cfg.n_heads, proj_factor=cfg.mlstm_proj_factor,
                dtype=cfg.cdtype, device=dev, lead=(n_groups, cfg.slstm_every - 1)),
            "slstm": xlstm_mod.init_slstm_cache(batch, cfg.d_model, device=dev,
                                                lead=(n_groups,)),
        }
    return {_CACHE_KEY[key]: attn_mod.init_cache(
        batch, max_len, cfg.n_kv_heads, cfg.resolved_head_dim, cfg.cdtype, dev, lead=(n,),
    ) for key, n in stack_sizes(cfg).items()}


def prefill(cfg: ArchConfig, params: dict, batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, dict]:
    """Full-sequence forward that also returns the decode cache of the
    prompt: (logits (B, S, V) fp32, cache).  Dense and moe: {"layers": {"k",
    "v": (L, B, S, Hkv, Dh)}}, and "dense" for moe's first_dense layers;
    xlstm: the state cache of `init_cache`, each block's final state in its
    slot (a prompt shorter than the convolution leaves the older conv_buf
    rows zero, as the convolution's padding)."""
    require_ported(cfg)
    params = cast_params(cfg, params)
    h = _embed_inputs(cfg, params, batch["tokens"])
    if cfg.family == "xlstm":
        cache = init_cache(cfg, h.shape[0], h.shape[1], device=h.device)
        for kind, gi, li, lp in _xlstm_layers(cfg, params):
            out, state = _xlstm_mixer(cfg, kind, lp, h, return_cache=True)
            h = h + out
            for name, t in state.items():
                slot = cache[kind][name][gi, li] if kind == "mlstm" else cache[kind][name][gi]
                if name == "conv_buf":  # (B, rows, d_inner), rows = min(S, width - 1)
                    slot = slot[:, -t.shape[1]:]
                slot.copy_(t)
        return _logits(cfg, params, h), cache
    positions = torch.arange(h.shape[1], device=h.device)
    cache = {}
    for key in stack_sizes(cfg):
        ks, vs = [], []
        for lp in params[key]:
            h, kv, _ = tfm.prefill_block(lp, h, positions, cfg)
            ks.append(kv["k"])
            vs.append(kv["v"])
        cache[_CACHE_KEY[key]] = {"k": torch.stack(ks), "v": torch.stack(vs)}
    return _logits(cfg, params, h), cache


def decode_step(
    cfg: ArchConfig,
    params: dict,
    cache: dict,
    tokens: torch.Tensor,  # (B, 1)
    pos: int,  # current position (write index; the xlstm state caches need none)
) -> Tuple[torch.Tensor, dict]:
    """Returns (logits (B, 1, V) fp32, the cache, updated in place)."""
    require_ported(cfg)
    params = cast_params(cfg, params)
    h = _embed_inputs(cfg, params, tokens)
    if cfg.family == "xlstm":
        for kind, gi, li, lp in _xlstm_layers(cfg, params):
            h_in = apply_norm(cfg.norm, lp["norm"], h)
            if kind == "mlstm":
                layer_cache = {name: t[gi, li] for name, t in cache["mlstm"].items()}
                out, _ = xlstm_mod.mlstm_decode(lp["mixer"], h_in, layer_cache,
                                                n_heads=cfg.n_heads,
                                                proj_factor=cfg.mlstm_proj_factor)
            else:
                layer_cache = {name: t[gi] for name, t in cache["slstm"].items()}
                out, _ = xlstm_mod.slstm_decode(lp["mixer"], h_in, layer_cache,
                                                n_heads=cfg.n_heads)
            h = h + out
        return _logits(cfg, params, h), cache
    for key in stack_sizes(cfg):
        layers = cache[_CACHE_KEY[key]]
        for i, lp in enumerate(params[key]):
            layer_cache = {"k": layers["k"][i], "v": layers["v"][i]}
            h, _, _ = tfm.decode_block(lp, h, layer_cache, pos, cfg)
    return _logits(cfg, params, h), cache
