"""Model assembly for the ported LM families: ArchConfig -> init / forward /
prefill / decode.

Port of src/repro/models/model.py, every family:
  dense   a pre-norm decoder stack (qwen3, olmo, granite, gemma);
  moe     the same stack with the MoE FFN (models/moe.py), after
          `first_dense` leading dense blocks (kimi's first layer);
  vlm     the dense stack over [projected image tokens, text tokens]: the
          batch's "img_embeds" (B, n_img_tokens, vision_dim) go through
          the projector and come before the text (phi-3-vision); decode
          steps are text tokens at positions n_img_tokens + prompt + i;
  audio   an encoder-only stack (cfg.causal False: K2 non-causal) over the
          frame projection of the batch's "features" (B, T, frame_dim),
          with an untied head over the cluster targets (hubert); prefill
          encodes and returns no cache, and there is no decode step;
  xlstm   groups of (slstm_every - 1) pre-norm mLSTM blocks followed by one
          pre-norm sLSTM block, whose recurrence is one K3 launch
          (models/xlstm.py; in training K3's forward with the plain BPTT
          backward, kernels/slstm_step/backward.py);
  hybrid  n_layers // attn_every groups of attn_every pre-norm Mamba2
          blocks (models/ssm.py, plain torch as JAX's einsums), each group
          followed by one application of the weight-TIED "shared_attn"
          transformer block (K2), then a tail of the remaining Mamba2
          blocks ("mamba_tail", when n_layers % attn_every) (zamba2).
Params are a dict tree in the JAX package's layouts, every stack's
tensors stacked on a leading layer axis (what the JAX side scans over:
"layers" for dense; "dense_layers", over first_dense blocks when it is
set, and "layers", over the rest, for moe; "mlstm", over n_groups *
(slstm_every - 1) blocks, and "slstm", over n_groups, for xlstm; "mamba",
over n_groups * attn_every blocks, and "mamba_tail" for hybrid, whose
"shared_attn" is one block with no layer axis, as JAX's); the port walks
the layers with a Python loop.  Every entry point takes the batch
as JAX's does (a dict of tensors or numpy arrays, moved to the params'
device): "tokens", and "img_embeds" for vlm, "features" for audio
("targets" and "mask" too for the audio loss).  Every entry point first
brings the params into the form it walks (`cast_params`): float tensors
in the compute dtype (the MoE router too: `apply_moe` widens it to fp32),
as the JAX `_cast_params` does, and each stack split into a list of
per-layer views.
A tree already in that form passes through untouched, so a server
prepares it once and its decode loop does no per-step tree work.  The
decode cache is updated in place (JAX returns a new one).

The cast runs inside the autograd graph, so the gradient of a loss reaches
the fp32 master params through it, and each stack splits with
`torch.unbind` (whose backward writes one stacked gradient, where the
backward of one `select` per layer would write a zero-filled copy of the
whole stack per layer).  When grad flows and `cfg.remat` is set, each
transformer layer (and each hybrid Mamba2 block and shared-block
application, and each xlstm mLSTM block) runs under
`torch.utils.checkpoint` (non-reentrant): only its input is kept, and its
forward runs again in the backward, as the JAX `_maybe_remat` with
`nothing_saveable`; its K2 launch then runs twice.  The sLSTM block is not
rematerialised, as JAX's is not (src/repro/models/model.py:298-305): K3
launches once an sLSTM block a step.
The shared block's applications reuse its tensors, so autograd sums its
gradient over them, as JAX's.

`forward` returns the MoE load-balance aux summed over every layer (dense
layers first; 0 without experts), and `loss_fn` is the fp32 cross-entropy
plus 0.01 x that aux: next-token over the text (vlm: the logits after the
image tokens), masked prediction of the targets at the masked frames
(audio).  The untied head (audio; any config without tie_embeddings) is
h @ head.w with fp32 accumulation.

`param_axes(cfg)` is the tree of the JAX package's logical axes for each
leaf (what `split_tree(M.init(cfg, key))[1]` gives there), in the port's
layouts; runtime/sharding.py maps it to mesh axes.

On a mesh (`forward` / `loss_fn` with `mesh=`, or the mesh a train step
installs through models/sharding_hook), the dense, MoE, hybrid and xlstm
families run on the rank's shards: the batch is this data rank's rows, every leaf the
rank's shard under the sharding rules; attention and the MLP are
tensor-parallel over `model`, the MoE FFN expert-parallel
(models/transformer.py), the embedding vocab-parallel, and the loss's
cross-entropy reduces the vocab-sharded fp32 logits over `model` without
gathering them (`_ce_vocab_parallel`: the row max by a pmax, the sum of
exponentials and the target's logit by psums); `forward` then returns the
logits of the rank's vocabulary range.  The residual stream's layout is
JAX's: where the installed rules (runtime/steps' `rules=`; else
rules_for(cfg), the one default) map "seq" to `model` and tp divides the
full S, `forward` and `prefill` shard it on its sequence
(models/sharding_hook, `hook.residual`): the embedding psum-scatters
onto the rank's S/tp positions, every block takes and returns that
slice (so the checkpoint of `_remat` keeps 1/tp of the replicated
residual a layer: its argument; `remat_saved` counts those bytes),
positions stay the whole sequence's, and `_logits` runs the final norm
on the slice before it gathers the sequence; the norms' scales, which each rank applies to its
positions only, have their gradients summed over `model`.  A decode step,
an S the axis does not divide, tp 1 and rules mapping "seq" to None keep
it replicated.  The loss is this data rank's mean;
runtime/steps averages the losses and gradients over `data`.  `prefill`,
`init_cache` and `decode_step` run on a mesh too (launch/serve --mesh):
the decode cache laid out by runtime/sharding.cache_spec (its sequence
over `model` where max_len divides it, `seq_sharded`; else its kv heads;
else replicated), the prefill's K/V laid into it by `merge_prefill_cache`.
An FSDP config (`fsdp_embed`) holds D / dp of every weight's `embed` dim
on a rank (`param_specs`); the entry points gather each such weight over
`data` before use (models/fsdp.py): the embedding table and the head
where they are read, each layer's weights at the entry of its block
(inside `_remat`'s checkpoint), an MoE layer's experts inside its FFN.
The hybrid and xlstm families run on a mesh too, with the same residual
layouts: the Mamba2 and mLSTM mixers tensor-parallel by heads over
`model` (models/ssm.py, models/xlstm.py; Mamba2's fused leaves cut segment
by segment, runtime/sharding's `Segmented`), the hybrid's shared block
as the dense blocks, and the sLSTM, whose weights are replicated, run on
every model rank over the rank's batch and the whole sequence (under SP:
its norm on the slice, `seq_whole` before it and `seq_part` after).  Their
decode caches on a rank: the hybrid's attention K/V as the dense cache,
its Mamba2 state by heads (conv_buf by segment); the mLSTM's state by
heads (ROADMAP section 1 records that departure from JAX's replicated
MLSTM_CACHE_AXES); the sLSTM's state the rank's rows.
The vlm and audio families and a `pod` axis raise NotImplementedError on
a mesh other than 1x1 (`check_mesh_supported`), in training and serving,
naming the ROADMAP item that lifts each; so do an xlstm whose heads the
model axis does not divide and a Mamba2 segment it does not divide.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Callable, Dict, Optional, Tuple

import torch
from torch.overrides import TorchFunctionMode
from torch.utils.checkpoint import checkpoint

from repro_torch.configs import PORTED_FAMILIES
from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import fsdp
from repro_torch.models import sharding_hook as hook
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import transformer as tfm
from repro_torch.models import xlstm as xlstm_mod
from repro_torch.models.layers import (apply_norm, dense_init, embed, embedding_axes,
                                       init_embedding, init_norm, norm_axes, stack_axes,
                                       unembed)
from repro_torch.runtime.mesh import DATA_AXIS, MODEL_AXIS, POD_AXIS, axis_sizes
from repro_torch.runtime.sharding import (Segmented, batch_spec, cache_spec, check_segments,
                                         rules_for, tree_specs)

# The ROADMAP items (section 1) that lift the refusals of a mesh.
MESH_ITEMS = {
    "families": "ROADMAP section 1, item 4: the vlm and audio families on a mesh",
    "pod": "ROADMAP section 1, item 5: a `pod` axis",
}
MESH_FAMILIES = ("dense", "moe", "hybrid", "xlstm")


def require_ported(cfg: ArchConfig) -> None:
    """Raise for what the port does not run: a family outside the registry,
    an xlstm depth that is not whole groups, a hybrid depth without one
    group (its shared block would never run)."""
    if cfg.family not in PORTED_FAMILIES:
        raise KeyError(f"{cfg.name}: unknown family {cfg.family!r}; the port runs "
                       f"{', '.join(PORTED_FAMILIES)}")
    if cfg.family == "xlstm" and (not cfg.slstm_every or cfg.n_layers % cfg.slstm_every):
        raise ValueError(f"{cfg.name}: xlstm expects n_layers % slstm_every == 0")
    if cfg.family == "hybrid" and (not cfg.attn_every or cfg.n_layers < cfg.attn_every):
        raise ValueError(f"{cfg.name}: hybrid expects n_layers >= attn_every (one group)")


def check_mesh_supported(cfg: ArchConfig, mesh) -> None:
    """Raise NotImplementedError for what the port does not run on a mesh
    other than 1x1 (a Mesh, a {axis: size} dict, or None), in training or
    serving: a family outside MESH_FAMILIES, a `pod` axis of more than one,
    an xlstm whose n_heads the model axis does not divide (JAX would keep
    wq whole and still cut `ffn`), a Mamba2 segment it does not divide."""
    sizes = axis_sizes(mesh)
    if all(n == 1 for n in sizes.values()):
        return
    shape = "x".join(str(n) for n in sizes.values())
    if cfg.family not in MESH_FAMILIES:
        raise NotImplementedError(
            f"{cfg.name} on mesh {shape}: the port runs the {cfg.family} family on one "
            f"device (mesh 1x1); the sharded-training and sharded-serving paths run the "
            f"{' and '.join(MESH_FAMILIES)} families ({MESH_ITEMS['families']})")
    if sizes.get(POD_AXIS, 1) > 1:
        raise NotImplementedError(
            f"{cfg.name} on mesh {shape}: the sharded-training and sharded-serving paths "
            f"have no `pod` axis of more than one rank ({MESH_ITEMS['pod']})")
    tp = sizes.get(MODEL_AXIS, 1)
    if cfg.family == "xlstm" and cfg.n_heads % tp:
        raise NotImplementedError(
            f"{cfg.name} on mesh {shape}: the sharded-training and sharded-serving paths cut "
            f"the mLSTM by heads, and n_heads {cfg.n_heads} does not split over tp {tp} "
            f"model ranks (ROADMAP section 1)")
    if cfg.family == "hybrid":  # in_proj's segments hold conv's [x, B, C]
        check_segments(Segmented(MODEL_AXIS, ssm_mod.segments(**_mamba_dims(cfg))["in_proj"]),
                       tp, f"{cfg.name} on mesh {shape}: Mamba2's in_proj: ")


def stack_sizes(cfg: ArchConfig) -> Dict[str, int]:
    """The layer stacks of the family and their depths."""
    if cfg.family == "xlstm":
        n_groups = cfg.n_layers // cfg.slstm_every
        return {"mlstm": n_groups * (cfg.slstm_every - 1), "slstm": n_groups}
    if cfg.family == "hybrid":
        n_grouped = cfg.n_layers // cfg.attn_every * cfg.attn_every
        n_tail = cfg.n_layers - n_grouped
        return {"mamba": n_grouped, **({"mamba_tail": n_tail} if n_tail else {})}
    if cfg.family == "moe" and cfg.first_dense:
        return {"dense_layers": cfg.first_dense, "layers": cfg.n_layers - cfg.first_dense}
    return {"layers": cfg.n_layers}


def tree_map(fn: Callable[[torch.Tensor], torch.Tensor], tree: dict) -> dict:
    """fn over every tensor of a nested dict."""
    return {k: tree_map(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def param_axes(cfg: ArchConfig) -> Dict[str, dict]:
    """The logical axes of every leaf of init(cfg) (tuples, one name or None
    a dim; a stack's layer dim None), as the JAX package's Param leaves."""
    require_ported(cfg)
    axes: Dict[str, dict] = {}
    if cfg.family == "audio":
        axes["frame_proj"] = tfm.frame_proj_axes()
    else:
        axes["embed"] = embedding_axes()
    if cfg.family == "audio" or not cfg.tie_embeddings:
        axes["head"] = {"w": ("embed", "vocab")}
    if cfg.family == "vlm":
        axes["projector"] = tfm.vlm_projector_axes()
    norm = norm_axes(cfg.norm)
    if cfg.family == "xlstm":
        axes["mlstm"] = stack_axes({"norm": norm, "mixer": xlstm_mod.mlstm_axes()})
        axes["slstm"] = stack_axes({"norm": norm, "mixer": xlstm_mod.slstm_axes()})
    elif cfg.family == "hybrid":
        for key in stack_sizes(cfg):
            axes[key] = stack_axes({"norm": norm, "mixer": ssm_mod.mamba2_axes(**_mamba_dims(cfg))})
        axes["shared_attn"] = tfm.block_axes(cfg)
    else:
        if "dense_layers" in stack_sizes(cfg):
            axes["dense_layers"] = stack_axes(tfm.dense_block_axes(cfg))
        axes["layers"] = stack_axes(tfm.block_axes(cfg))
    axes["final_norm"] = norm
    return axes


class _OnMeta(TorchFunctionMode):
    """Every factory call that names a device makes its tensor on the meta
    device instead (no storage, no random draws: a draw becomes
    `torch.empty`, whose meta form does not load torch's compiler stack as
    the meta `randn` does, once in each process of a sharded run)."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        if "device" in kwargs:
            kwargs["device"] = "meta"
            if func is torch.randn:
                kwargs.pop("generator", None)
                func = torch.empty
        return func(*args, **kwargs)


def abstract_params(cfg: ArchConfig) -> Dict[str, dict]:
    """init(cfg)'s tree on the meta device: its global shapes and dtypes."""
    with _OnMeta():
        return init(cfg, 0, "cpu")


@functools.lru_cache(maxsize=16)
def _param_specs(cfg: ArchConfig, sizes: Tuple[Tuple[str, int], ...]) -> Dict[str, dict]:
    return tree_specs(dict(sizes), param_axes(cfg), abstract_params(cfg), rules_for(cfg))


def param_specs(cfg: ArchConfig, mesh) -> Dict[str, dict]:
    """The spec of every leaf of init(cfg) on `mesh` (a Mesh or a {axis:
    size} dict) under the config's rules (runtime/sharding): the tree the
    runtime cuts the params by.  Shared: not to be changed."""
    return _param_specs(cfg, tuple(axis_sizes(mesh).items()))


def _gather_specs(cfg: ArchConfig, key: str) -> Optional[dict]:
    """The specs that models/fsdp gathers params[key] by on the installed
    mesh (a layer of a stack: its layer dim dropped), or None where none of
    its leaves is sharded over `data` (no mesh, a `data` axis of one rank,
    a config without fsdp_embed)."""
    mesh = hook.current_mesh()
    if mesh is None or mesh.size(DATA_AXIS) == 1:
        return None
    specs = param_specs(cfg, mesh)[key]
    if key in stack_sizes(cfg):
        specs = tree_map(lambda s: s[1:], specs)
    return specs if fsdp.any_sharded(specs) else None


def _block_fn(cfg: ArchConfig, key: str, fn: Callable) -> Callable:
    """A block function of `tfm` for the layers of stack `key`, which
    gathers the layer's FSDP-sharded weights at its entry."""
    specs = _gather_specs(cfg, key)
    return fn if specs is None else functools.partial(fn, specs=specs)


def cast_params(cfg: ArchConfig, params: dict) -> dict:
    """The params as the entry points walk them: float tensors in the
    compute dtype, each layer stack a list of per-layer trees (views of the
    stacked tensors; hybrid's shared block stays one tree).  A tree already
    in that form is returned as it is."""
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
    params = {}
    if cfg.family == "audio":
        params["frame_proj"] = tfm.init_frame_proj(gen, cfg.frame_dim, cfg.d_model, cfg.dtype)
    else:
        params["embed"] = init_embedding(gen, cfg.vocab, cfg.d_model, cfg.dtype)
    if cfg.family == "audio" or not cfg.tie_embeddings:
        params["head"] = {"w": dense_init(gen, (cfg.d_model, cfg.vocab), cfg.dtype,
                                          fan_in=cfg.d_model)}
    if cfg.family == "vlm":
        params["projector"] = tfm.init_vlm_projector(gen, cfg.vision_dim, cfg.d_model, cfg.dtype)
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
    elif cfg.family == "hybrid":
        for key, n in stack_sizes(cfg).items():
            params[key] = {
                "norm": init_norm(cfg.norm, cfg.d_model, cfg.dtype, dev, (n,)),
                "mixer": ssm_mod.init_mamba2(gen, cfg.d_model, d_state=cfg.ssm_state,
                                             head_dim=cfg.ssm_head_dim, expand=cfg.ssm_expand,
                                             dtype=cfg.dtype, lead=(n,)),
            }
        params["shared_attn"] = tfm.init_block(gen, cfg, None)
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


def _embed_tokens(cfg: ArchConfig, params: dict, tokens) -> torch.Tensor:
    table = params["embed"]["table"]
    tokens = torch.as_tensor(tokens, device=table.device).long()
    return embed(fsdp.gather_tree(params["embed"], _gather_specs(cfg, "embed")), tokens,
                 scale_by_dim=cfg.embed_scale, vocab=cfg.vocab).to(cfg.cdtype)


def _embed_inputs(cfg: ArchConfig, params: dict, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The stack's input (B, S, D) in the compute dtype: audio the frame
    projection of "features"; else the token embedding, for vlm after the
    projected "img_embeds" when the batch has them."""
    cdt = cfg.cdtype
    if cfg.family == "audio":
        w = params["frame_proj"]["w"]
        return tfm.apply_frame_proj(params["frame_proj"],
                                    torch.as_tensor(batch["features"], device=w.device), cdt)
    h = _embed_tokens(cfg, params, batch["tokens"])
    if cfg.family == "vlm" and "img_embeds" in batch:
        img = torch.as_tensor(batch["img_embeds"], device=h.device)
        h = torch.cat([tfm.apply_vlm_projector(params["projector"], img, cdt), h], dim=1)
    return h


def _logits(cfg: ArchConfig, params: dict, h: torch.Tensor) -> torch.Tensor:
    """fp32 logits: the tied unembedding, or h @ head.w (audio, untied).
    Both operands widen to fp32 (exact from bf16), as `unembed` does, for
    JAX's fp32 accumulation of the compute-dtype product.  Where h is the
    rank's slice of the sequence (models/sharding_hook), the final norm
    runs on it and the product on the gathered sequence: the logits are
    always the whole sequence's."""
    h = apply_norm(cfg.norm, hook.seq_shared(params["final_norm"]), h)
    if cfg.family == "audio" or not cfg.tie_embeddings:
        w = fsdp.gather_tree(params["head"], _gather_specs(cfg, "head"))["w"]
        # a vocab-parallel head gives the rank's logits
        h = hook.column_in(h) if w.shape[-1] != cfg.vocab else hook.seq_whole(h)
        return torch.matmul(h.float(), w.float())
    return unembed(fsdp.gather_tree(params["embed"], _gather_specs(cfg, "embed")), h,
                   vocab=cfg.vocab)


def _xlstm_layers(cfg: ArchConfig, params: dict):
    """The xlstm blocks in order: (kind, group, index in group, layer params),
    kind "mlstm" (index 0 .. slstm_every - 2) or "slstm" (index 0)."""
    per = cfg.slstm_every - 1
    for gi in range(cfg.n_layers // cfg.slstm_every):
        for li in range(per):
            yield "mlstm", gi, li, params["mlstm"][gi * per + li]
        yield "slstm", gi, 0, params["slstm"][gi]


def _xlstm_layer(lp: dict, h: torch.Tensor, cfg: ArchConfig, kind: str) -> torch.Tensor:
    """One pre-norm xlstm block over the full sequence."""
    return h + _xlstm_mixer(cfg, kind, lp, h, return_cache=False)


def _xlstm_mixer(cfg: ArchConfig, kind: str, lp: dict, h: torch.Tensor, return_cache: bool):
    """One xlstm block's mixer output on the residual's layout (its norm on
    the rank's slice where the residual is sharded on its sequence).  The
    sLSTM, replicated over `model`, runs on every model rank over the whole
    sequence of the rank's rows: `seq_whole` in, `seq_part` out (the
    identities on a replicated residual), so its gradient comes out whole
    on every rank with no sum over `model`."""
    h_in = apply_norm(cfg.norm, hook.seq_shared(lp["norm"]), h)
    if kind == "mlstm":
        return xlstm_mod.mlstm_block(lp["mixer"], h_in, n_heads=cfg.n_heads,
                                     proj_factor=cfg.mlstm_proj_factor, chunk=cfg.ssm_chunk,
                                     return_cache=return_cache)
    got = xlstm_mod.slstm_block(lp["mixer"], hook.seq_whole(h_in), n_heads=cfg.n_heads,
                                return_cache=return_cache)
    if return_cache:
        return hook.seq_part(got[0]), got[1]
    return hook.seq_part(got)


def _hybrid_layers(cfg: ArchConfig, params: dict):
    """The hybrid blocks in order: (kind, index into its cache stack, params):
    ("mamba", (group, i), ...) for the attn_every blocks of each group, then
    ("attn", (group,), the shared block), and ("mamba_tail", (i,), ...)."""
    g = cfg.attn_every
    for gi in range(cfg.n_layers // g):
        for i in range(g):
            yield "mamba", (gi, i), params["mamba"][gi * g + i]
        yield "attn", (gi,), params["shared_attn"]
    for i, lp in enumerate(params.get("mamba_tail", [])):
        yield "mamba_tail", (i,), lp


def _mamba_kw(cfg: ArchConfig) -> dict:
    return dict(d_state=cfg.ssm_state, head_dim=cfg.ssm_head_dim, expand=cfg.ssm_expand)


def _mamba_dims(cfg: ArchConfig) -> dict:
    """The widths of Mamba2's segments (models/ssm.segments)."""
    d_inner = cfg.ssm_expand * cfg.d_model
    return dict(d_inner=d_inner, d_state=cfg.ssm_state, n_heads=d_inner // cfg.ssm_head_dim)


def _mamba_mixer(cfg: ArchConfig, lp: dict, h: torch.Tensor, return_cache: bool = False):
    """One Mamba2 block's mixer output (its norm on the residual's layout)."""
    h_in = apply_norm(cfg.norm, hook.seq_shared(lp["norm"]), h)
    return ssm_mod.mamba2_block(lp["mixer"], h_in, chunk=cfg.ssm_chunk,
                                return_cache=return_cache, **_mamba_kw(cfg))


def _mamba_layer(lp: dict, h: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """One pre-norm Mamba2 block over the full sequence."""
    return h + _mamba_mixer(cfg, lp, h)


_SAVED = [None]  # remat_saved's list while one is open


@contextlib.contextmanager
def remat_saved():
    """Yields a list that gets, for each layer `_remat` checkpoints in the
    body, the bytes of its checkpoint's floating-point tensor arguments
    (the residual h; the layer's weights come in a dict and live on with
    the model), which non-reentrant checkpoint holds for the recompute
    in place of the layer's activations.  It counts the arguments, not
    the allocator: the memory held is read on the card (chip_smoke's SP
    check)."""
    got, saved = [], _SAVED[0]
    _SAVED[0] = got
    try:
        yield got
    finally:
        _SAVED[0] = saved


def _remat(cfg: ArchConfig, fn: Callable, *args):
    """fn(*args), under non-reentrant checkpoint when cfg.remat is set and
    grad flows into any of the args (the recompute under the mesh, rules
    and residual layout installed now)."""
    if cfg.remat and _needs_grad(*args):
        if _SAVED[0] is not None:
            _SAVED[0].append(sum(a.numel() * a.element_size() for a in args
                                 if isinstance(a, torch.Tensor) and a.is_floating_point()))
        return checkpoint(hook.bind(fn), *args, use_reentrant=False)
    return fn(*args)


# ---------------------------------------------------------------------------
# Forward, prefill, decode
# ---------------------------------------------------------------------------


def forward(cfg: ArchConfig, params: dict, batch: Dict[str, torch.Tensor],
            mesh=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (logits (B, S, V) fp32, moe_aux scalar: 0 without experts).
    On a mesh (given, with rules_for(cfg); or installed with its rules):
    the rank's batch and shards, and the logits of the rank's
    vocabulary range."""
    require_ported(cfg)
    with hook.installed(mesh):
        return _forward(cfg, params, batch)


def _seq_len(cfg: ArchConfig, batch) -> int:
    """The stack's whole sequence length (a vlm's image positions first)."""
    if cfg.family == "audio":
        return batch["features"].shape[1]
    s = batch["tokens"].shape[1]
    if cfg.family == "vlm" and "img_embeds" in batch:
        s += batch["img_embeds"].shape[1]
    return s


def _forward(cfg: ArchConfig, params: dict, batch) -> Tuple[torch.Tensor, torch.Tensor]:
    check_mesh_supported(cfg, hook.current_mesh())
    params = cast_params(cfg, params)
    seq_len = _seq_len(cfg, batch)
    with hook.residual(seq_len, rules_for(cfg)):  # the residual's layout (models/sharding_hook)
        return _forward_stack(cfg, params, batch, seq_len)


def _forward_stack(cfg: ArchConfig, params: dict, batch,
                   seq_len: int) -> Tuple[torch.Tensor, torch.Tensor]:
    h = _embed_inputs(cfg, params, batch)
    if cfg.family == "xlstm":
        for kind, _, _, lp in _xlstm_layers(cfg, params):
            if kind == "mlstm":
                h = _remat(cfg, _xlstm_layer, lp, h, cfg, kind)
            else:  # JAX does not remat the sLSTM block: K3 runs once a step
                h = _xlstm_layer(lp, h, cfg, kind)
        return _logits(cfg, params, h), torch.zeros((), device=h.device)
    positions = torch.arange(seq_len, device=h.device)  # the whole sequence's
    aux_total = torch.zeros((), device=h.device)
    if cfg.family == "hybrid":
        for kind, _, lp in _hybrid_layers(cfg, params):
            if kind == "attn":
                h = _remat(cfg, tfm.apply_block, lp, h, positions, cfg)[0]
            else:
                h = _remat(cfg, _mamba_layer, lp, h, cfg)
        return _logits(cfg, params, h), aux_total
    for key in stack_sizes(cfg):  # the dense layers first
        block = _block_fn(cfg, key, tfm.apply_block)
        for lp in params[key]:
            h, aux = _remat(cfg, block, lp, h, positions, cfg)
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


def _ce_vocab_parallel(logits: torch.Tensor, targets: torch.Tensor, mask: torch.Tensor,
                       mesh) -> Tuple[torch.Tensor, torch.Tensor]:
    """_ce over logits sharded on the vocabulary over `model` (the rank's
    range [r V/tp, (r+1) V/tp)), never gathered: the row max by a pmax (a
    constant of the gradient), the sum of exponentials and the target's
    logit (from the rank that holds it) by psums."""
    logits = logits.float()
    v_loc = logits.shape[-1]
    with torch.no_grad():
        m = mesh.pmax(logits.max(dim=-1).values, MODEL_AXIS)
    sumexp = hook.leave_model(torch.exp(logits - m[..., None]).sum(dim=-1))
    lse = torch.log(sumexp) + m
    local = targets.long() - mesh.index(MODEL_AXIS) * v_loc
    inside = (local >= 0) & (local < v_loc)
    gold = torch.gather(logits, -1, torch.clamp(local, 0, v_loc - 1)[..., None])[..., 0]
    gold = hook.leave_model(gold.masked_fill(~inside, 0))
    nll = (lse - gold) * mask
    n = torch.clamp(torch.sum(mask), min=1.0)
    return torch.sum(nll) / n, n


def loss_fn(cfg: ArchConfig, params: dict, batch: Dict[str, torch.Tensor],
            mesh=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Cross-entropy plus 0.01 x moe_aux (0 without experts): (total, {"ce",
    "moe_aux", "n_tokens"}).  Next-token (logits[:, :-1] against
    tokens[:, 1:], every position counting; dense, moe, xlstm and hybrid) over the
    text: for vlm the logits after the n_img_tokens image positions; audio:
    the targets at the frames of batch["mask"].  On a mesh (given, or
    installed, as `forward`'s): this data rank's loss over its rows."""
    require_ported(cfg)
    with hook.installed(mesh):
        return _loss(cfg, params, batch)


def _loss(cfg: ArchConfig, params: dict, batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    logits, aux = _forward(cfg, params, batch)
    dev = logits.device
    mesh = hook.current_mesh()
    ce = _ce
    if mesh is not None and logits.shape[-1] != cfg.vocab:
        ce = lambda lg, t, msk: _ce_vocab_parallel(lg, t, msk, mesh)  # noqa: E731
    if cfg.family == "audio":
        mask = torch.as_tensor(batch["mask"], device=dev).float()
        loss, n = ce(logits, torch.as_tensor(batch["targets"], device=dev).long(), mask)
    else:
        if cfg.family == "vlm":
            logits = logits[:, cfg.n_img_tokens:, :]
        tokens = torch.as_tensor(batch["tokens"], device=dev).long()
        mask = torch.ones(tokens[:, 1:].shape, dtype=torch.float32, device=dev)
        loss, n = ce(logits[:, :-1, :], tokens[:, 1:], mask)
    total = loss + 0.01 * aux
    return total, {"ce": loss, "moe_aux": aux, "n_tokens": n}


# The cache entry of each transformer layer stack (JAX's names).
_CACHE_KEY = {"dense_layers": "dense", "layers": "layers"}


def seq_sharded(cfg: ArchConfig, mesh, max_len: int) -> bool:
    """Whether a decode cache of max_len positions is sharded on its
    sequence over `model` on `mesh` (runtime/sharding.cache_spec: when
    max_len divides the model axis of more than one rank)."""
    sizes = axis_sizes(mesh)
    if sizes.get(MODEL_AXIS, 1) == 1:
        return False
    dp = sizes.get(POD_AXIS, 1) * sizes.get(DATA_AXIS, 1)
    return cache_spec(cfg, sizes, dp, max_len)[1] is not None


def _local_cache_shape(cfg: ArchConfig, mesh, batch: int, max_len: int) -> Tuple[int, ...]:
    """(B, T, Hkv, Dh) of one layer's K or V on this rank of `mesh`."""
    shape = [batch, max_len, cfg.n_kv_heads, cfg.resolved_head_dim]
    if mesh is None:
        return tuple(shape)
    dp = mesh.size(POD_AXIS) * mesh.size(DATA_AXIS)
    if batch % dp:
        raise ValueError(f"{cfg.name}: a batch of {batch} does not split over the {dp} data "
                         f"ranks of mesh {mesh.describe()}")
    for dim, part in enumerate(cache_spec(cfg, mesh, batch, max_len)):
        for a in (() if part is None else (part,) if isinstance(part, str) else part):
            shape[dim] //= mesh.size(a)
    return tuple(shape)


def init_cache(cfg: ArchConfig, batch: int, max_len: int, device: DeviceLike = "cuda",
               mesh=None) -> dict:
    """The decode cache, zero but for the stabilizers m (-1e30).  Dense and
    moe: {"layers": {"k", "v": (L, B, max_len, Hkv, Dh)}} in the compute
    dtype; moe with first_dense: {"dense": the first_dense layers' cache,
    "layers": the rest's}; vlm as dense, max_len counting the image
    positions; audio raises (encoder-only: no decode).  On a mesh (dense
    and moe; `batch` and `max_len` global), the rank's shard under
    runtime/sharding.cache_spec: its B / dp rows, and its max_len / tp
    positions (`seq_sharded`) or else its Hkv / tp kv heads where they
    divide, else every kv head.
    xlstm (state caches; max_len unused): {"mlstm": {"conv_buf" (compute
    dtype), "C", "n", "m" (fp32)}, each (n_groups, slstm_every - 1, B, ...),
    "slstm": {"h", "c", "n", "m"}, each (n_groups, B, D) fp32}.
    hybrid: {"mamba": {"conv_buf" (n_groups, attn_every, B, 3, conv_dim) in
    the compute dtype, "S" (n_groups, attn_every, B, H, N, P) fp32}, "attn":
    {"k", "v": (n_groups, B, max_len, Hkv, Dh)} (one per application of the
    shared block), and "mamba_tail" as "mamba" with (n_tail,) in front}.
    On a mesh: hybrid's "attn" as the dense cache, its Mamba2 states the
    rank's rows, segments (conv_buf) and heads (S); xlstm's mLSTM states
    the rank's rows and heads (conv_buf's channels, C, n, m), its sLSTM
    states the rank's rows."""
    require_ported(cfg)
    if cfg.family == "audio":
        raise ValueError(f"{cfg.name}: encoder-only arch has no decode cache")
    dev = resolve_device(device)
    if mesh is not None:
        check_mesh_supported(cfg, mesh)
    b, t, hkv, dh = _local_cache_shape(cfg, mesh, batch, max_len)
    if cfg.family in ("hybrid", "xlstm"):
        states = _state_cache(cfg, b, dev, 1 if mesh is None else mesh.size(MODEL_AXIS))
        if cfg.family == "xlstm":
            return states
        n_groups = cfg.n_layers // cfg.attn_every
        return {"attn": attn_mod.init_cache(b, t, hkv, dh, cfg.cdtype, dev, lead=(n_groups,)),
                **states}
    return {_CACHE_KEY[key]: attn_mod.init_cache(b, t, hkv, dh, cfg.cdtype, dev, lead=(n,))
            for key, n in stack_sizes(cfg).items()}


def cache_specs(cfg: ArchConfig, mesh, batch: int, max_len: int) -> dict:
    """The spec of every leaf of init_cache(cfg, batch, max_len, mesh=mesh)
    on `mesh` (a Mesh or a {axis: size} dict): the tree by which
    runtime/sharding.unshard_tree gathers a rank's cache whole.  K/V as
    `cache_spec` (a layer dim in front); a Mamba2 conv_buf's channels by
    segment, its S by heads; an mLSTM state by heads; every state's batch
    over the data axes."""
    sizes = axis_sizes(mesh)
    rules = rules_for(cfg)
    rows = batch_spec(sizes, rules)[0]
    model = MODEL_AXIS if sizes.get(MODEL_AXIS, 1) > 1 else None
    kv = (None,) + cache_spec(cfg, sizes, batch, max_len, rules)
    if cfg.family == "xlstm":
        return {"mlstm": {"conv_buf": (None, None, rows, None, model),
                          "C": (None, None, rows, model, None, None),
                          "n": (None, None, rows, model, None),
                          "m": (None, None, rows, model)},
                "slstm": {name: (None, rows, None) for name in ("h", "c", "n", "m")}}
    if cfg.family != "hybrid":
        return {_CACHE_KEY[key]: {"k": kv, "v": kv} for key in stack_sizes(cfg)}
    xbc = None if model is None else Segmented(model, ssm_mod.segments(**_mamba_dims(cfg))["xbc"])
    specs = {"attn": {"k": kv, "v": kv}}
    for key in stack_sizes(cfg):  # "mamba" (group, block) and "mamba_tail" (block)
        lead = (None,) * (2 if key == "mamba" else 1)
        specs[key] = {"conv_buf": lead + (rows, None, xbc), "S": lead + (rows, model, None, None)}
    return specs


def _state_cache(cfg: ArchConfig, batch: int, dev, model_ranks: int) -> dict:
    """The recurrent state caches (zero, m -1e30) of the hybrid ("mamba",
    "mamba_tail") or xlstm ("mlstm", "slstm") family for `batch` rows, each
    Mamba2 and mLSTM state one rank's part of `model_ranks`."""
    if cfg.family == "xlstm":
        n_groups = cfg.n_layers // cfg.slstm_every
        return {
            "mlstm": xlstm_mod.init_mlstm_cache(
                batch, cfg.d_model, cfg.n_heads, proj_factor=cfg.mlstm_proj_factor,
                dtype=cfg.cdtype, device=dev, lead=(n_groups, cfg.slstm_every - 1),
                model_ranks=model_ranks),
            "slstm": xlstm_mod.init_slstm_cache(batch, cfg.d_model, device=dev,
                                                lead=(n_groups,)),
        }
    sizes = stack_sizes(cfg)
    leads = {"mamba": (cfg.n_layers // cfg.attn_every, cfg.attn_every)}
    if "mamba_tail" in sizes:
        leads["mamba_tail"] = (sizes["mamba_tail"],)
    return {key: ssm_mod.init_mamba2_cache(batch, cfg.d_model, dtype=cfg.cdtype, device=dev,
                                           lead=lead, model_ranks=model_ranks, **_mamba_kw(cfg))
            for key, lead in leads.items()}


def merge_prefill_cache(cfg: ArchConfig, cache: dict, pre_cache: dict, mesh=None,
                        max_len: Optional[int] = None) -> dict:
    """Lay the prefill's K/V into the decode cache, in place, for every
    attention stack of `cache` ({stack: {"k", "v": (L, B, T, Hkv, Dh)}}):
    the prompt's S positions first, the later ones left zero.  On a mesh
    whose cache is sharded on its sequence (`seq_sharded`, max_len the
    global length), each rank keeps the positions it holds: a slice of the
    prefill's when kv is whole (no collective), or, when the prefill gave
    the rank its kv heads only, one all_to_all over `model` that trades
    (my heads, your positions) for (every head, my positions)."""
    seq = mesh is not None and seq_sharded(cfg, mesh, max_len)
    for stack, layers in cache.items():
        part = pre_cache[stack]
        if "k" not in layers:
            for name, full in layers.items():
                full.copy_(part[name])
            continue
        s_len = part["k"].shape[2]
        if not seq:
            for name, full in layers.items():
                full[:, :, :s_len] = part[name]
            continue
        r, n = mesh.index(MODEL_AXIS), mesh.size(MODEL_AXIS)
        t_loc = layers["k"].shape[2]
        if part["k"].shape[3] == layers["k"].shape[3]:  # every kv head: this rank's positions
            lo, hi = r * t_loc, min(s_len, (r + 1) * t_loc)
            for name, full in layers.items():
                if hi > lo:
                    full[:, :, :hi - lo] = part[name][:, :, lo:hi]
            continue
        both = torch.stack([part["k"], part["v"]])  # (2, L, B, S, Hkv / tp, Dh)
        two, n_l, b, _, h_p, dh = both.shape
        padded = both.new_zeros(two, n_l, b, n * t_loc, h_p, dh)
        padded[:, :, :, :s_len] = both
        send = padded.view(two, n_l, b, n, t_loc, h_p, dh).permute(3, 0, 1, 2, 4, 5, 6)
        got = mesh.all_to_all_tiled(send.contiguous(), MODEL_AXIS)  # chunk j: rank j's heads
        got = got.permute(1, 2, 3, 4, 0, 5, 6).reshape(two, n_l, b, t_loc, n * h_p, dh)
        layers["k"].copy_(got[0])
        layers["v"].copy_(got[1])
    return cache


def prefill(cfg: ArchConfig, params: dict, batch: Dict[str, torch.Tensor],
            mesh=None) -> Tuple[torch.Tensor, dict]:
    """Full-sequence forward that also returns the decode cache of the
    prompt: (logits (B, S, V) fp32, cache).  Dense, moe and vlm: {"layers":
    {"k", "v": (L, B, S, Hkv, Dh)}} (vlm: S counts the image positions
    first), and "dense" for moe's first_dense layers; audio encodes: the
    forward's logits and a cache of None;
    xlstm and hybrid: the cache of `init_cache` (hybrid's K/V of S
    positions), each block's final state in its slot (a prompt shorter than
    the convolution leaves the older conv_buf rows zero, as the
    convolution's padding).  On a mesh (given, or installed; as
    `forward`'s): the rank's rows and shards,
    tensor-parallel (and sequence-parallel) as `forward`; the logits of
    the rank's vocabulary range over the whole sequence, and the K/V of
    its kv heads (every kv head where kv_heads stay whole) over the whole
    sequence, the recurrent states in `init_cache(mesh=)`'s layout."""
    if cfg.family == "audio":
        return forward(cfg, params, batch, mesh)[0], None
    require_ported(cfg)
    with hook.installed(mesh):
        check_mesh_supported(cfg, hook.current_mesh())
        params = cast_params(cfg, params)
        seq_len = _seq_len(cfg, batch)
        with hook.residual(seq_len, rules_for(cfg)):
            return _prefill(cfg, params, batch, seq_len)


def _prefill(cfg: ArchConfig, params: dict, batch, seq_len: int) -> Tuple[torch.Tensor, dict]:
    h = _embed_inputs(cfg, params, batch)
    if cfg.family in ("xlstm", "hybrid"):
        cache = _state_cache(cfg, h.shape[0], h.device, hook.model_size())
    if cfg.family == "xlstm":
        for kind, gi, li, lp in _xlstm_layers(cfg, params):
            out, state = _xlstm_mixer(cfg, kind, lp, h, return_cache=True)
            h = h + out
            for name, t in state.items():
                slot = cache[kind][name][gi, li] if kind == "mlstm" else cache[kind][name][gi]
                if name == "conv_buf":  # (B, rows, d_inner), rows = min(S, width - 1)
                    slot = slot[:, -t.shape[1]:]
                slot.copy_(t)
        return _logits(cfg, params, h), cache
    positions = torch.arange(seq_len, device=h.device)  # the whole sequence's
    if cfg.family == "hybrid":
        kvs = []
        for kind, at, lp in _hybrid_layers(cfg, params):
            if kind == "attn":
                h, kv, _ = tfm.prefill_block(lp, h, positions, cfg)
                kvs.append(kv)
                continue
            out, state = _mamba_mixer(cfg, lp, h, return_cache=True)
            h = h + out
            for name, t in state.items():
                slot = cache[kind][name][at]
                if name == "conv_buf":  # (B, rows, conv_dim), rows = min(S, width - 1)
                    slot = slot[:, -t.shape[1]:]
                slot.copy_(t)
        attn = {name: torch.stack([kv[name] for kv in kvs]) for name in ("k", "v")}
        return _logits(cfg, params, h), {"attn": attn, **cache}
    cache = {}
    for key in stack_sizes(cfg):
        ks, vs = [], []
        block = _block_fn(cfg, key, tfm.prefill_block)
        for lp in params[key]:
            h, kv, _ = block(lp, h, positions, cfg)
            ks.append(kv["k"])
            vs.append(kv["v"])
        cache[_CACHE_KEY[key]] = {"k": torch.stack(ks), "v": torch.stack(vs)}
    return _logits(cfg, params, h), cache


def decode_step(
    cfg: ArchConfig,
    params: dict,
    cache: dict,
    tokens: torch.Tensor,  # (B, 1)
    pos: int,  # current position (write index; the state caches need none)
    mesh=None,
    max_len: Optional[int] = None,
) -> Tuple[torch.Tensor, dict]:
    """Returns (logits (B, 1, V) fp32, the cache, updated in place).  A vlm
    step is a text token: pos counts the image positions of the prompt.  On
    a mesh (given, or installed): the rank's rows, its
    cache shard of a cache of `max_len` positions (`init_cache`'s layout,
    which max_len fixes), the logits of its vocabulary range."""
    require_ported(cfg)
    if cfg.family == "audio":
        raise ValueError(f"{cfg.name}: encoder-only arch has no decode step")
    with hook.installed(mesh):
        mesh = hook.current_mesh()
        check_mesh_supported(cfg, mesh)
        if mesh is not None and mesh.size(MODEL_AXIS) > 1 and max_len is None:
            raise ValueError("decode_step on a mesh with a model axis needs max_len, the "
                             "cache's global length (its layout)")
        seq = mesh is not None and seq_sharded(cfg, mesh, max_len)
        with hook.residual(1, rules_for(cfg)):  # a decode step's residual stays replicated
            return _decode_step(cfg, params, cache, tokens, pos, seq)


def _decode_step(cfg: ArchConfig, params: dict, cache: dict, tokens, pos: int,
                 seq: bool) -> Tuple[torch.Tensor, dict]:
    params = cast_params(cfg, params)
    h = _embed_tokens(cfg, params, tokens)
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
    if cfg.family == "hybrid":
        for kind, at, lp in _hybrid_layers(cfg, params):
            layer_cache = {name: t[at] for name, t in cache[kind].items()}
            if kind == "attn":
                h, _, _ = tfm.decode_block(lp, h, layer_cache, pos, cfg, seq)
            else:
                h_in = apply_norm(cfg.norm, lp["norm"], h)
                out, _ = ssm_mod.mamba2_decode(lp["mixer"], h_in, layer_cache, **_mamba_kw(cfg))
                h = h + out
        return _logits(cfg, params, h), cache
    for key in stack_sizes(cfg):
        layers = cache[_CACHE_KEY[key]]
        block = _block_fn(cfg, key, tfm.decode_block)
        for i, lp in enumerate(params[key]):
            layer_cache = {"k": layers["k"][i], "v": layers["v"][i]}
            h, _, _ = block(lp, h, layer_cache, pos, cfg, seq)
    return _logits(cfg, params, h), cache
