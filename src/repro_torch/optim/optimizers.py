"""Fused optimizers over nested dicts of tensors.

Port of src/repro/optim/optimizers.py.  Optimizer = (init, update,
state_axes, name):

  init(params) -> state, trees of fp32 tensors that mirror the params;
  update(grads, state, params, step, shards=None) -> (params, state);
  state_axes(param_axes) -> the logical axes of the state's leaves, from
    the params' (`model.param_axes`), as JAX's: the runtime shards the
    state by them (Adafactor's factored moments drop the factored dim's
    axis).

All moments are fp32 whatever the param dtype; the update is computed in
fp32 and cast back to the param dtype (the bf16-param + fp32-state regime
of the 1T-class config).  Where the JAX update returns new trees, this one
writes the new values into `params` and `state` in place, under
torch.no_grad, and returns the same objects; clipping scales `grads` in
place.  `step` is the step count (int or 0-d tensor) before the update,
and `lr` a float or a schedule of it.

On a mesh the params, gradients and state are the rank's shards, and
`shards` (a `Shards`) says how: the clipping norm is then the global norm
of the whole gradient (each sharded leaf's sum of squares summed over the
axes it is sharded on, a leaf replicated over them counted once).  AdamW
and SGD are elementwise, so they run on the shard as they are.
Adafactor's means span a whole leaf, as JAX's GSPMD takes them: on a
shard each mean over a dim the mesh cuts is the local sum, psum'd over the
axes that cut it and divided by the whole dim's count (vr's over the last
dim, vc's over dim -2, the denominator's over vr's last dim, which is
dim -2), and the RMS clip's mean of u^2 is psum'd over every axis the leaf
is cut on; a dim no axis cuts keeps torch.mean, so the one-device update
is unchanged.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import torch

from repro_torch.pytree import leaves, tree_map


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[..., tuple]
    state_axes: Callable[[Any], Any]
    name: str = "opt"


@dataclasses.dataclass(frozen=True)
class Shards:
    """How a sharded run's params are cut (runtime/steps.shards_for builds
    it): `norm(grads)` is the global norm of the whole gradient; `dims`
    holds, for each leaf in the params' leaf order, the mesh axes that cut
    each of its dims (() for a dim held whole); `psum(x, axis)` sums x over
    a mesh axis and `size(axis)` is that axis's rank count."""
    norm: Callable[[Any], torch.Tensor]
    dims: Tuple[Tuple[Tuple[str, ...], ...], ...]
    psum: Callable[[torch.Tensor, str], torch.Tensor]
    size: Callable[[str], int]


def _mean(x: torch.Tensor, shards: Optional[Shards], axes: Tuple[str, ...], dim=None,
          keepdim: bool = False) -> torch.Tensor:
    """The mean of the whole tensor that x is this rank's shard of, over
    `dim` (every dim when None), which the mesh axes `axes` cut: the local
    sum psum'd over them, over the whole count (torch.mean where nothing
    cuts it)."""
    if not axes:
        return torch.mean(x) if dim is None else torch.mean(x, dim=dim, keepdim=keepdim)
    total = torch.sum(x) if dim is None else torch.sum(x, dim=dim, keepdim=keepdim)
    count = x.numel() if dim is None else x.shape[dim]
    for a in axes:
        total = shards.psum(total, a)
        count *= shards.size(a)
    return total / count


def _is_axes(x) -> bool:
    return isinstance(x, tuple)


def _tree_f32(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)


def _lr_fn(lr) -> Callable[[int], float]:
    return lr if callable(lr) else (lambda step: float(lr))


def _global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(g.float() ** 2) for g in leaves(tree)))


@torch.no_grad()
def _clipped(grads, clip_norm: Optional[float], shards: Optional[Shards] = None):
    """grads scaled in place by min(1, clip_norm / (|grads| + 1e-9)), the
    norm of the whole gradient across shards."""
    if clip_norm is None:
        return grads
    norm = _global_norm(grads) if shards is None else shards.norm(grads)
    scale = torch.clamp(clip_norm / (norm + 1e-9), max=1.0)
    for g in leaves(grads):
        g.mul_(scale.to(g.dtype))
    return grads


def _store(p: torch.Tensor, value: torch.Tensor) -> None:
    """p <- value (fp32), cast to p's dtype."""
    p.copy_(value.to(p.dtype))


# ---------------------------------------------------------------------------
# SGD (+momentum)
# ---------------------------------------------------------------------------


def sgd(lr, momentum: float = 0.0, clip_norm: Optional[float] = None) -> Optimizer:
    lr_fn = _lr_fn(lr)

    def init(params):
        if momentum:
            return {"mu": _tree_f32(params)}
        return {}

    @torch.no_grad()
    def update(grads, state, params, step, shards=None):
        grads = _clipped(grads, clip_norm, shards)
        lr_t = lr_fn(int(step))
        if momentum:
            for p, g, m in zip(leaves(params), leaves(grads), leaves(state["mu"])):
                m.copy_(momentum * m + g.float())
                _store(p, p.float() - lr_t * m)
            return params, state
        for p, g in zip(leaves(params), leaves(grads)):
            _store(p, p.float() - lr_t * g.float())
        return params, state

    def state_axes(param_axes):
        return {"mu": param_axes} if momentum else {}

    return Optimizer(init, update, state_axes, name="sgd")


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def adamw(
    lr,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    clip_norm: Optional[float] = 1.0,
) -> Optimizer:
    lr_fn = _lr_fn(lr)

    def init(params):
        return {"m": _tree_f32(params), "v": _tree_f32(params)}

    @torch.no_grad()
    def update(grads, state, params, step, shards=None):
        grads = _clipped(grads, clip_norm, shards)
        t = int(step) + 1
        lr_t = lr_fn(int(step))
        bc1 = 1.0 - b1 ** t
        bc2 = 1.0 - b2 ** t
        for p, g, m, v in zip(leaves(params), leaves(grads), leaves(state["m"]),
                              leaves(state["v"])):
            g = g.float()
            m.copy_(b1 * m + (1 - b1) * g)
            v.copy_(b2 * v + (1 - b2) * g * g)
            pf = p.float()
            upd = (m / bc1) / (torch.sqrt(v / bc2) + eps) + weight_decay * pf
            _store(p, pf - lr_t * upd)
            del g, pf, upd
        return params, state

    def state_axes(param_axes):
        return {"m": param_axes, "v": param_axes}

    return Optimizer(init, update, state_axes, name="adamw")


# ---------------------------------------------------------------------------
# Adafactor (factored second moment)
# ---------------------------------------------------------------------------


def _factored(shape) -> bool:
    # Purely structural (ndim >= 2), as the JAX side.
    return len(shape) >= 2


def adafactor(
    lr,
    eps: float = 1e-30,
    clip_threshold: float = 1.0,
    decay_pow: float = 0.8,
    weight_decay: float = 0.0,
    clip_norm: Optional[float] = None,
) -> Optimizer:
    """Adafactor without momentum: O(sum-of-dims) state per matrix instead of
    O(product)."""
    lr_fn = _lr_fn(lr)

    def init(params):
        def one(p):
            dev = p.device
            if _factored(p.shape):
                return {"vr": torch.zeros(p.shape[:-1], dtype=torch.float32, device=dev),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], dtype=torch.float32,
                                          device=dev)}
            return {"v": torch.zeros(p.shape, dtype=torch.float32, device=dev)}

        return {"f": tree_map(one, params)}

    @torch.no_grad()
    def update(grads, state, params, step, shards=None):
        grads = _clipped(grads, clip_norm, shards)
        t = float(int(step) + 1)
        beta2t = 1.0 - t ** (-decay_pow)
        lr_t = lr_fn(int(step))
        # the per-param states, in the params' leaf order (each a dict)
        states = _param_states(state["f"], params)
        for i, (p, g, s) in enumerate(zip(leaves(params), leaves(grads), states)):
            dims = ((),) * p.dim() if shards is None else shards.dims[i]
            g = g.float()
            g2 = g * g + eps
            if "vr" in s:
                s["vr"].copy_(beta2t * s["vr"] + (1 - beta2t) * _mean(g2, shards, dims[-1], -1))
                s["vc"].copy_(beta2t * s["vc"] + (1 - beta2t) * _mean(g2, shards, dims[-2], -2))
                denom = _mean(s["vr"], shards, dims[-2], -1, keepdim=True)
                u = (g / torch.sqrt(s["vr"] / torch.clamp(denom, min=eps))[..., None]
                     / torch.sqrt(s["vc"])[..., None, :])
            else:
                s["v"].copy_(beta2t * s["v"] + (1 - beta2t) * g2)
                u = g / torch.sqrt(s["v"])
            every = tuple(a for d in dims for a in d)
            rms = torch.sqrt(_mean(u * u, shards, every))  # RMS update clipping
            u = u / torch.clamp(rms / clip_threshold, min=1.0)
            pf = p.float()
            if weight_decay:
                u = u + weight_decay * pf
            _store(p, pf - lr_t * u)
        return params, state

    def state_axes(param_axes):
        def one(axes):
            axes = tuple(axes)
            if len(axes) >= 2:  # mirror _factored on the axes tuple
                return {"vr": axes[:-1], "vc": axes[:-2] + axes[-1:]}
            return {"v": axes}

        return {"f": tree_map(one, param_axes, is_leaf=_is_axes)}

    return Optimizer(init, update, state_axes, name="adafactor")


def _param_states(f, params) -> list:
    """The state dicts of `f` ({"vr", "vc"} or {"v"}, one per param) in the
    params' leaf order: `f` mirrors the params with a dict at each leaf."""
    out: list = []
    _collect_states(f, params, out)
    return out


def _collect_states(fs, ps, out: list) -> None:
    # module-level recursion: a self-calling closure would be a reference
    # cycle holding the optimizer state until the garbage collector runs
    if isinstance(ps, dict):
        for k in sorted(ps):
            _collect_states(fs[k], ps[k], out)
    else:
        out.append(fs)


def for_arch(cfg, lr=None) -> Optimizer:
    """The deployment choice: Adafactor for the 1T-class (bf16-param)
    config, AdamW elsewhere."""
    if cfg.param_dtype == "bfloat16":
        return adafactor(lr if lr is not None else 1e-3)
    return adamw(lr if lr is not None else 3e-4)

