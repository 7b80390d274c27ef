"""Train, prefill and decode steps of the LM substrate.

Port of src/repro/runtime/steps.py:

  init_train_state(cfg, opt, seed, device, mesh=None)
                                   -> {"params", "opt", "step"}; on a mesh
                                   the global params are built from the
                                   seed exactly as on one device, then the
                                   rank keeps its shard
  abstract_train_state(cfg, opt)   the global tree on the meta device
                                   (shapes and dtypes, no storage;
                                   jax.eval_shape's role), the `like` of a
                                   restore
  state_shardings(cfg, opt, mesh)  the spec of every leaf of the state
                                   (params by model.param_axes, the
                                   optimizer's by its state_axes, the step
                                   replicated), under the config's rules
  make_train_step(cfg, opt, mesh=None, rules=None)
                                   (state, batch) -> (state, metrics): the
                                   batch onto the params' device
                                   (`batch_to_device`), the loss and its
                                   gradient, `opt.update`, step + 1; the
                                   state is updated in place
  make_prefill_step, make_decode_step  the serve steps over model.prefill
                                   and model.decode_step; on a mesh the
                                   rank's rows and shards, the greedy
                                   argmax vocab-parallel (`greedy_tokens`)

The step counter is a 0-d int32 tensor, as JAX's.

On a mesh (runtime/mesh.Mesh) the step installs the mesh and the
sharding rules for the model code (models/sharding_hook: the residual
sharded on its sequence over `model` where the rules say so and tp
divides S, JAX's layout), takes this data rank's rows of the batch
(B % dp == 0), and computes its loss and the gradient of its shards; the
gradients are then averaged over `data` (each data rank's loss is a mean
over the same number of tokens, as JAX's global mean), the clipping norm
is the whole gradient's (optim.Shards, `shards_for`: also what
Adafactor's means psum over), and `opt.update` runs on the shard.  An
FSDP config's weights (their `embed` dim over `data`) are gathered over
`data` before use (models/fsdp); their gradients come back summed over
`data` by the gather's psum_scatter, and the mean divides them.  The
metrics are the means over `data` (n_tokens the sum); the step's
collectives and wire bytes per axis go to `mesh.step_traffic`.  JAX's
GSPMD places the same collectives; `jit_train_step` and the `lower_*`
functions are XLA's (ROADMAP section 1, the XLA-only tooling).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import model as M
from repro_torch.models import sharding_hook as hook
from repro_torch.optim.optimizers import Optimizer, Shards
from repro_torch.pytree import leaves, unflatten
from repro_torch.runtime.mesh import DATA_AXIS, MODEL_AXIS, POD_AXIS, Mesh
from repro_torch.runtime.sharding import rules_for, shard_tree, spec_axes, tree_specs


def _is_spec(x) -> bool:
    return isinstance(x, tuple)


def state_shardings(cfg: ArchConfig, opt: Optimizer, mesh) -> Dict[str, Any]:
    """The spec of every leaf of the train state on `mesh` (a Mesh or a
    {axis: size} dict) under the config's rules: {"params", "opt" (trees
    of specs), "step": ()}."""
    like = abstract_train_state(cfg, opt)
    return {"params": M.param_specs(cfg, mesh),
            "opt": tree_specs(mesh, opt.state_axes(M.param_axes(cfg)), like["opt"],
                              rules_for(cfg)),
            "step": ()}


def init_train_state(cfg: ArchConfig, opt: Optimizer, seed: int = 0,
                     device: DeviceLike = "cuda", mesh: Optional[Mesh] = None) -> Dict[str, Any]:
    """Random params from `seed` (model.init), the optimizer's state and a
    step of 0, on `device`; on a mesh, the rank's shard of each (the global
    params drawn first, as on one device)."""
    M.require_ported(cfg)
    dev = resolve_device(device)
    params = M.init(cfg, seed, dev)
    if mesh is not None:
        M.check_mesh_supported(cfg, mesh)
        params = shard_tree(params, state_shardings(cfg, opt, mesh)["params"], mesh)
    return {"params": params, "opt": opt.init(params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def abstract_train_state(cfg: ArchConfig, opt: Optimizer) -> Dict[str, Any]:
    """init_train_state's tree on the meta device."""
    params = M.abstract_params(cfg)
    return {"params": params, "opt": opt.init(params),
            "step": torch.zeros((), dtype=torch.int32, device="meta")}


def batch_to_device(batch: Dict[str, Any], device) -> Dict[str, Any]:
    """Every entry of a batch (numpy arrays or tensors: "tokens", audio's
    float "features", int "targets" and bool "mask", vlm's float
    "img_embeds") as a tensor on `device`, dtypes kept."""
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def _dp_axes(mesh: Mesh):
    return tuple(a for a in (POD_AXIS, DATA_AXIS) if mesh.size(a) > 1)


def data_shard(batch: Dict[str, Any], mesh: Mesh) -> Dict[str, Any]:
    """This data rank's rows of every batch entry (the leading dim split
    over `pod` x `data`, row-major)."""
    idx, dp = 0, 1
    for a in (POD_AXIS, DATA_AXIS):
        idx, dp = idx * mesh.size(a) + mesh.index(a), dp * mesh.size(a)
    if dp == 1:
        return batch
    out = {}
    for k, v in batch.items():
        b = v.shape[0]
        if b % dp:
            raise ValueError(f"batch entry {k!r}: B % dp == 0 is needed to split the batch "
                             f"over the data axis ({b} % {dp})")
        out[k] = v[idx * (b // dp):(idx + 1) * (b // dp)]
    return out


def _mesh_axes(spec, mesh: Mesh):
    return tuple(a for a in spec_axes(spec) if mesh.size(a) > 1)


def _mesh_norm(mesh: Mesh, flat_specs):
    """The global norm of a sharded gradient: each leaf's sum of squares,
    summed over the axes the leaf is sharded on (a replicated leaf once)."""
    def norm(grads) -> torch.Tensor:
        groups: Dict[Tuple[str, ...], list] = {}
        for g, spec in zip(leaves(grads), flat_specs):
            groups.setdefault(_mesh_axes(spec, mesh), []).append(g)
        total = 0
        for axes, gs in groups.items():
            part = sum(torch.sum(g.float() ** 2) for g in gs)
            for a in axes:
                part = mesh.psum(part, a)
            total = total + part
        return torch.sqrt(total)
    return norm


def _average_over_data(mesh: Mesh, grads, flat_specs) -> list:
    """The gradients' mean over the data axes, one psum for all the leaves;
    a gradient whose leaf is sharded over a data axis (FSDP) already holds
    the sum there (its gather's transpose) and is divided only."""
    dp_axes = _dp_axes(mesh)
    if not dp_axes:
        return list(grads)
    out = list(grads)
    for a in dp_axes:
        summed = [i for i, s in enumerate(flat_specs) if a not in spec_axes(s)]
        if summed:
            flat = torch.cat([out[i].reshape(-1).float() for i in summed])
            flat = mesh.psum(flat, a)
            at = 0
            for i in summed:
                n = out[i].numel()
                out[i] = flat[at:at + n].view_as(out[i]).to(out[i].dtype)
                at += n
        out = [g / mesh.size(a) for g in out]
    return out


def make_train_step(cfg: ArchConfig, opt: Optimizer, mesh: Optional[Mesh] = None,
                    rules=None) -> Callable:
    """One step: loss and gradient (model.loss_fn), `opt.update` in place,
    step + 1.  Returns (state, {"loss", "ce", "moe_aux", "n_tokens"}), the
    metrics 0-d tensors without grad.  On a mesh, the rank's step of a
    sharded run (see the module's docstring) under `rules` (default
    rules_for(cfg)), installed with the mesh as JAX's jit_train_step(rules=)
    installs them: rules_for(cfg, {"seq": None}) keeps the residual
    replicated over `model`."""
    M.require_ported(cfg)
    if mesh is not None:
        return _make_sharded_train_step(cfg, opt, mesh, rules)

    def train_step(state: Dict[str, Any], batch: Dict[str, Any]):
        params = state["params"]
        flat = leaves(params)
        batch = batch_to_device(batch, flat[0].device)
        with torch.enable_grad():
            for p in flat:
                p.requires_grad_(True)
            loss, metrics = M.loss_fn(cfg, params, batch)
            grads = torch.autograd.grad(loss, flat)
        opt.update(unflatten(params, grads), state["opt"], params, state["step"])
        del grads
        with torch.no_grad():
            state["step"] += 1
        out = {"loss": loss.detach(), **{k: v.detach() for k, v in metrics.items()}}
        return state, out

    return train_step


def shards_for(mesh: Mesh, flat_specs) -> Shards:
    """How params cut by `flat_specs` (their specs in leaf order) lie on
    `mesh`, for `opt.update`: the global clip norm, each dim's cutting axes
    (those of more than one rank), the psum."""
    return Shards(norm=_mesh_norm(mesh, flat_specs),
                  dims=tuple(tuple(_mesh_axes((part,), mesh) for part in spec)
                             for spec in flat_specs),
                  psum=mesh.psum, size=mesh.size)


def _make_sharded_train_step(cfg: ArchConfig, opt: Optimizer, mesh: Mesh,
                             rules) -> Callable:
    M.check_mesh_supported(cfg, mesh)
    flat_specs = leaves(state_shardings(cfg, opt, mesh)["params"], is_leaf=_is_spec)
    shards = shards_for(mesh, flat_specs)

    def train_step(state: Dict[str, Any], batch: Dict[str, Any]):
        before = {a: list(c) for a, c in mesh.traffic.items()}
        params = state["params"]
        flat = leaves(params)
        batch = batch_to_device(data_shard(batch, mesh), flat[0].device)
        with torch.enable_grad(), hook.installed(mesh, rules):
            for p in flat:
                p.requires_grad_(True)
            loss, metrics = M.loss_fn(cfg, params, batch)
            grads = torch.autograd.grad(loss, flat)
        grads = _average_over_data(mesh, grads, flat_specs)
        opt.update(unflatten(params, grads), state["opt"], params, state["step"], shards)
        del grads
        with torch.no_grad():
            state["step"] += 1
            means = torch.stack([loss.detach(), metrics["ce"].detach(),
                                 metrics["moe_aux"].detach().float()])
            n_tokens = metrics["n_tokens"].detach()
            for a in _dp_axes(mesh):
                means = mesh.psum(means, a) / mesh.size(a)
                n_tokens = mesh.psum(n_tokens, a)
        out = {"loss": means[0], "ce": means[1], "moe_aux": means[2], "n_tokens": n_tokens}
        mesh.step_traffic = {a: [n - before.get(a, [0, 0])[0], b - before.get(a, [0, 0])[1]]
                             for a, (n, b) in mesh.traffic.items()}
        return state, out

    return train_step


def greedy_tokens(cfg: ArchConfig, logits: torch.Tensor,
                  mesh: Optional[Mesh] = None) -> torch.Tensor:
    """The greedy next token of each row of the last position's fp32 logits
    (B, V), int64 (B,).  Logits sharded on the vocabulary over `model` (the
    rank's range [r V/tp, (r + 1) V/tp)): each rank's max and the first
    index of it, gathered over `model`; the largest value wins, and of
    equal values the lowest global index, which is torch.argmax's rule over
    the whole row.  Where the vocabulary does not divide tp the logits are
    whole on every rank, and the plain argmax runs."""
    if mesh is None or logits.shape[-1] == cfg.vocab:
        return torch.argmax(logits, dim=-1)
    idx = torch.argmax(logits, dim=-1)
    val = torch.gather(logits, -1, idx[:, None])[:, 0]
    idx = idx + mesh.index(MODEL_AXIS) * logits.shape[-1]
    pairs = torch.stack([val.double(), idx.double()], dim=-1)[None]  # exact in fp64
    pairs = mesh.all_gather_tiled(pairs, MODEL_AXIS, 0)  # (tp, B, 2), in rank order
    best = torch.argmax(pairs[..., 0], dim=0)  # the first rank holding the max
    return torch.gather(pairs[..., 1], 0, best[None])[0].long()


def make_decode_step(cfg: ArchConfig, mesh: Optional[Mesh] = None,
                     max_len: Optional[int] = None) -> Callable:
    """(params, cache, tokens (B, 1), pos) -> (next tokens (B,) int32, the
    cache updated in place).  On a mesh, the rank's rows and shards of a
    cache of max_len positions, the argmax vocab-parallel
    (`greedy_tokens`)."""
    def serve_step(params, cache, tokens, pos):
        logits, new_cache = M.decode_step(cfg, params, cache, tokens, pos, mesh, max_len)
        next_tok = greedy_tokens(cfg, logits[:, -1, :], mesh).to(torch.int32)
        return next_tok, new_cache

    return serve_step


def make_prefill_step(cfg: ArchConfig, mesh: Optional[Mesh] = None) -> Callable:
    """(params, batch) -> (the last position's logits (B, 1, V), the
    prefill's cache); on a mesh, the rank's rows, vocabulary range and
    kv heads."""
    def prefill_step(params, batch) -> Tuple[torch.Tensor, dict]:
        logits, cache = M.prefill(cfg, params, batch, mesh)
        return logits[:, -1:, :], cache

    return prefill_step
