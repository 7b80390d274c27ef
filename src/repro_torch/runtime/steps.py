"""Train, prefill and decode steps of the LM substrate.

Port of the single-device parts of src/repro/runtime/steps.py:

  init_train_state(cfg, opt, seed, device) -> {"params", "opt", "step"}
  abstract_train_state(cfg, opt)   the same tree on the meta device (shapes
                                   and dtypes, no storage; jax.eval_shape's
                                   role), the `like` of a restore
  make_train_step(cfg, opt)        (state, batch) -> (state, metrics): the
                                   batch onto the params' device
                                   (`batch_to_device`), the loss and its
                                   gradient, `opt.update`, step + 1; the
                                   state is updated in place
  make_prefill_step, make_decode_step  the serve steps over model.prefill
                                   and model.decode_step

The step counter is a 0-d int32 tensor, as JAX's.  The sharding hooks,
`jit_train_step` and the `lower_*` functions are XLA's (ROADMAP section 1,
the XLA-only tooling and the sharded-training items).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch
from torch.overrides import TorchFunctionMode

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import model as M
from repro_torch.optim.optimizers import Optimizer
from repro_torch.pytree import leaves, unflatten


def init_train_state(cfg: ArchConfig, opt: Optimizer, seed: int = 0,
                     device: DeviceLike = "cuda") -> Dict[str, Any]:
    """Random params from `seed` (model.init), the optimizer's state and a
    step of 0, on `device`."""
    M.require_ported(cfg)
    dev = resolve_device(device)
    params = M.init(cfg, seed, dev)
    return {"params": params, "opt": opt.init(params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


class _OnMeta(TorchFunctionMode):
    """Every factory call that names a device makes its tensor on the meta
    device instead (no storage, no random draws)."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        if "device" in kwargs:
            kwargs["device"] = "meta"
        return func(*args, **kwargs)


def abstract_train_state(cfg: ArchConfig, opt: Optimizer) -> Dict[str, Any]:
    """init_train_state's tree on the meta device."""
    M.require_ported(cfg)
    with _OnMeta():
        params = M.init(cfg, 0, "cpu")
        return {"params": params, "opt": opt.init(params),
                "step": torch.zeros((), dtype=torch.int32, device="meta")}


def batch_to_device(batch: Dict[str, Any], device) -> Dict[str, Any]:
    """Every entry of a batch (numpy arrays or tensors: "tokens", audio's
    float "features", int "targets" and bool "mask", vlm's float
    "img_embeds") as a tensor on `device`, dtypes kept."""
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def make_train_step(cfg: ArchConfig, opt: Optimizer) -> Callable:
    """One step: loss and gradient (model.loss_fn), `opt.update` in place,
    step + 1.  Returns (state, {"loss", "ce", "moe_aux", "n_tokens"}), the
    metrics 0-d tensors without grad."""
    M.require_ported(cfg)

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


def make_decode_step(cfg: ArchConfig) -> Callable:
    def serve_step(params, cache, tokens, pos):
        logits, new_cache = M.decode_step(cfg, params, cache, tokens, pos)
        next_tok = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
        return next_tok, new_cache

    return serve_step


def make_prefill_step(cfg: ArchConfig) -> Callable:
    def prefill_step(params, batch) -> Tuple[torch.Tensor, dict]:
        logits, cache = M.prefill(cfg, params, batch)
        return logits[:, -1:, :], cache

    return prefill_step
