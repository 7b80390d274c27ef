"""Fused optimizers over nested dicts of tensors.

Port of src/repro/optim/optimizers.py.  Optimizer = (init, update, name):

  init(params) -> state, trees of fp32 tensors that mirror the params;
  update(grads, state, params, step) -> (params, state).

All moments are fp32 whatever the param dtype; the update is computed in
fp32 and cast back to the param dtype (the bf16-param + fp32-state regime
of the 1T-class config).  Where the JAX update returns new trees, this one
writes the new values into `params` and `state` in place, under
torch.no_grad, and returns the same objects; clipping scales `grads` in
place.  `step` is the step count (int or 0-d tensor) before the update,
and `lr` a float or a schedule of it.  The JAX Optimizer's `state_axes`
(the sharding of the state for NamedSharding) has no counterpart on one
card: sharded training is a later item (ROADMAP section 1).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from repro_torch.pytree import leaves, tree_map


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any, Any], tuple]
    name: str = "opt"


def _tree_f32(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)


def _lr_fn(lr) -> Callable[[int], float]:
    return lr if callable(lr) else (lambda step: float(lr))


def _global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(g.float() ** 2) for g in leaves(tree)))


@torch.no_grad()
def _clipped(grads, clip_norm: Optional[float]):
    """grads scaled in place by min(1, clip_norm / (|grads| + 1e-9))."""
    if clip_norm is None:
        return grads
    scale = torch.clamp(clip_norm / (_global_norm(grads) + 1e-9), max=1.0)
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
    def update(grads, state, params, step):
        grads = _clipped(grads, clip_norm)
        lr_t = lr_fn(int(step))
        if momentum:
            for p, g, m in zip(leaves(params), leaves(grads), leaves(state["mu"])):
                m.copy_(momentum * m + g.float())
                _store(p, p.float() - lr_t * m)
            return params, state
        for p, g in zip(leaves(params), leaves(grads)):
            _store(p, p.float() - lr_t * g.float())
        return params, state

    return Optimizer(init, update, name="sgd")


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
    def update(grads, state, params, step):
        grads = _clipped(grads, clip_norm)
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

    return Optimizer(init, update, name="adamw")


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
    def update(grads, state, params, step):
        grads = _clipped(grads, clip_norm)
        t = float(int(step) + 1)
        beta2t = 1.0 - t ** (-decay_pow)
        lr_t = lr_fn(int(step))
        # the per-param states, in the params' leaf order (each a dict)
        states = _param_states(state["f"], params)
        for p, g, s in zip(leaves(params), leaves(grads), states):
            g = g.float()
            g2 = g * g + eps
            if "vr" in s:
                s["vr"].copy_(beta2t * s["vr"] + (1 - beta2t) * torch.mean(g2, dim=-1))
                s["vc"].copy_(beta2t * s["vc"] + (1 - beta2t) * torch.mean(g2, dim=-2))
                denom = torch.mean(s["vr"], dim=-1, keepdim=True)
                u = (g / torch.sqrt(s["vr"] / torch.clamp(denom, min=eps))[..., None]
                     / torch.sqrt(s["vc"])[..., None, :])
            else:
                s["v"].copy_(beta2t * s["v"] + (1 - beta2t) * g2)
                u = g / torch.sqrt(s["v"])
            rms = torch.sqrt(torch.mean(u * u))  # RMS update clipping
            u = u / torch.clamp(rms / clip_threshold, min=1.0)
            pf = p.float()
            if weight_decay:
                u = u + weight_decay * pf
            _store(p, pf - lr_t * u)
        return params, state

    return Optimizer(init, update, name="adafactor")


def _param_states(f, params) -> list:
    """The state dicts of `f` ({"vr", "vc"} or {"v"}, one per param) in the
    params' leaf order: `f` mirrors the params with a dict at each leaf."""
    out = []

    def walk(fs, ps):
        if isinstance(ps, dict):
            for k in sorted(ps):
                walk(fs[k], ps[k])
        else:
            out.append(fs)

    walk(f, params)
    return out


def for_arch(cfg, lr=None) -> Optimizer:
    """The deployment choice: Adafactor for the 1T-class (bf16-param)
    config, AdamW elsewhere."""
    if cfg.param_dtype == "bfloat16":
        return adafactor(lr if lr is not None else 1e-3)
    return adamw(lr if lr is not None else 3e-4)

