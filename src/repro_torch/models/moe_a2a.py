"""All-to-all expert-parallel MoE: tokens travel to their experts' ranks.

Port of src/repro/models/moe_a2a.py.  The JAX function runs its body
under shard_map with explicit collectives; here the body runs on every
rank of the mesh with the collectives of runtime/mesh.py.  Per rank (i on
`data`, j on `model`), with E_loc = E / tp experts a rank:

  0. this rank's slice of the sequence, S / tp positions, the shard JAX's
     P(batch, model, None) gives it: as it comes where the residual is
     sharded on its sequence (`seq_sharded`, models/sharding_hook), else
     cut from the residual (B_loc, S, D) replicated over `model` (the
     backward gathers the slices' gradients back);
  1. route locally (the router replicated over `model`: its gradient is
     summed over `model` on the way back, Megatron's f; gathered over
     `data` where its spec shards it there, FSDP, as JAX's body gathers
     it);
  2. bucket the assignments by destination model rank under JAX's
     capacity c_send = max(1, round(T_loc k / tp * capacity_factor)), in
     JAX's order (token-major, slot-minor cumsum);
  3. all_to_all over `model`: the (tp, c_send, D) token payload and the
     local expert id of each row (-1 for an empty row);
  4. dispatch the received rows to the E_loc local experts under
     c_exp = max(1, round(tp c_send / E_loc * capacity_factor));
  5. gather the expert weights over `data` where their specs shard
     `embed` there (cfg.fsdp_embed: models/fsdp.gather, whose transpose is
     the gradients' psum_scatter; JAX's body always gathers them, its
     shard_map putting `embed` on `data`; without FSDP the port holds them
     whole and there is nothing to gather);
  6. the SwiGLU expert FFN (three batched GEMMs), un-dispatch, all_to_all
     back, and the gated combine of each token's k rows;
  7. on the replicated layout, all_gather the slices over `model` back.

The load-balance aux is the global one: the router's mean probability and
routed share per expert, averaged over `model` and `data` as JAX's body
pmeans them (over `model`, the mean's gradient reaches each slice's
router; over `data`, each data rank's gradient carries its own shard's
term, which the step's average over `data` completes).

Dispatch and combine are gathers both ways (moe.ToSlots / FromSlots), as
in models/moe.py: no scatter-add, so a replayed step gives the same bits.
`wire_dtype="int8"` moves int8 payloads with per-row fp16 scales
(`q8_all_to_all`, `q8_all_gather`); their backward is straight-through,
the cotangent moving unquantized.  A shared expert (kimi's) runs beside
the routed experts, column- then row-parallel when its ffn is sharded
over `model` (f and g on the replicated residual; the sequence's
all-gather and psum-scatter on a sharded one), gathered over `data`
first where it is FSDP-sharded (native: JAX gathers it so).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import fsdp
from repro_torch.models.moe import FromSlots, ToSlots, _experts, _route, _shared
from repro_torch.runtime import mesh as mesh_mod
from repro_torch.runtime.mesh import DATA_AXIS, MODEL_AXIS, Mesh


# ---------------------------------------------------------------------------
# int8 wire compression (straight-through backward)
# ---------------------------------------------------------------------------


def _q8(x: torch.Tensor, axis: int = -1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 per slice along `axis` with an fp16 scale (JAX's
    dist.quantize_q8(x, axis, scale_dtype=float16)): scale = max|x| / 127
    + 1e-30 rounded to fp16, q = round(x / scale) clipped to [-127, 127].
    A slice of zeros has a scale of 0 in fp16 and codes 0."""
    scale = (x.abs().amax(dim=axis, keepdim=True) / 127.0 + 1e-30).to(torch.float16)
    s = scale.to(x.dtype)
    q = torch.where(s > 0, torch.clamp(torch.round(x / s), -127, 127), torch.zeros_like(x))
    return q.to(torch.int8), scale


class _Q8AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, gather_axis, scale_axis):
        ctx.mesh, ctx.axis, ctx.gather_axis = mesh, axis, gather_axis
        q, s = _q8(x, scale_axis)
        qg = mesh.all_gather_tiled(q, axis, gather_axis)
        sg = mesh.all_gather_tiled(s, axis, gather_axis)
        return qg.to(x.dtype) * sg.to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        return ctx.mesh.psum_scatter_tiled(dy, ctx.axis, ctx.gather_axis), None, None, None, None


class _Q8AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        q, s = _q8(x)
        return (mesh.all_to_all_tiled(q, axis).to(x.dtype)
                * mesh.all_to_all_tiled(s, axis).to(x.dtype))

    @staticmethod
    def backward(ctx, dy):
        return ctx.mesh.all_to_all_tiled(dy, ctx.axis), None, None


def q8_all_gather(x, mesh: Mesh, axis: str, gather_axis: int, scale_axis: int = -1):
    """all_gather with an int8 payload and fp16 scales along scale_axis
    (which must differ from gather_axis); psum_scatter backward."""
    return x if mesh.size(axis) == 1 else _Q8AllGather.apply(x, mesh, axis, gather_axis,
                                                              scale_axis)


def q8_all_to_all(x, mesh: Mesh, axis: str):
    """all_to_all over the leading dim with an int8 payload; its backward
    moves the cotangent unquantized."""
    return x if mesh.size(axis) == 1 else _Q8AllToAll.apply(x, mesh, axis)


# ---------------------------------------------------------------------------
# Bucketing
# ---------------------------------------------------------------------------


def _count_dispatch(ids: torch.Tensor, n_bins: int, cap: int):
    """ids (N,) in [0, n_bins) -> (slot (N,), valid (N,)): slot = bin * cap
    + position in its bin, n_bins * cap where past the capacity."""
    onehot = F.one_hot(ids, n_bins).to(torch.int32)
    pos = torch.cumsum(onehot, dim=0, dtype=torch.int32) - 1
    pos_in_bin = torch.gather(pos, 1, ids[:, None])[:, 0]
    valid = pos_in_bin < cap
    slot = torch.where(valid, ids * cap + pos_in_bin, n_bins * cap)
    return slot, valid


def _scatter_rows(values: torch.Tensor, slot: torch.Tensor, n_slots: int) -> torch.Tensor:
    """Rows of `values` (N, ...) written at `slot` into (n_slots, ...)
    zeros, slots out of range dropped (JAX's .at[slot].set(mode="drop")).
    For the integer tables: the slots in range are distinct."""
    out = values.new_zeros((n_slots + 1,) + values.shape[1:])
    out[torch.clamp(slot, max=n_slots)] = values
    return out[:n_slots]


def _inverse(slot: torch.Tensor, n_slots: int):
    """For slots 0 .. n_slots - 1: the row written there and whether one was
    (slot (N,) with distinct values in range)."""
    n = slot.shape[0]
    row = _scatter_rows(torch.arange(n, device=slot.device) + 1, slot, n_slots) - 1
    return torch.clamp(row, min=0), row >= 0


# ---------------------------------------------------------------------------
# The body and its wrapper
# ---------------------------------------------------------------------------


def _data_axes(mesh: Mesh) -> Tuple[str, ...]:
    return tuple(a for a in (DATA_AXIS,) if a in mesh.shape)


def _gathered(params: dict, name: str, specs: Optional[dict], mesh: Mesh,
              wire_dtype: str = "native", scale_axis: int = -1) -> torch.Tensor:
    """params[name] whole on the dims its spec shards over `data`
    (models/fsdp.gather; with no specs, as it is), on the int8 wire with
    fp16 scales along scale_axis when wire_dtype is "int8"."""
    if specs is None:
        return params[name]
    wire = (functools.partial(q8_all_gather, scale_axis=scale_axis) if wire_dtype == "int8"
            else mesh_mod.all_gather)
    return fsdp.gather(params[name], specs[name], mesh, wire)


def _global_mean(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The mean over `model` and `data` of a per-rank mean, as JAX's pmeans.
    Over `model` the gradient is the mean's (1 / tp to each slice); over
    `data` the value is the mean's and the gradient passes as it is (each
    data rank's gradient holds its own shard's term; the step averages the
    gradients over `data`)."""
    x = mesh_mod.g(x, mesh, MODEL_AXIS) / mesh.size(MODEL_AXIS)
    return mesh_mod.pmean_value(x, mesh, _data_axes(mesh))


def moe_a2a_body(mesh: Mesh, params: dict, x: torch.Tensor, *, top_k: int, n_experts: int,
                 capacity_factor: float, specs: Optional[dict] = None,
                 wire_dtype: str = "native") -> Tuple[torch.Tensor, torch.Tensor]:
    """The per-rank body on this rank's slice x (B_loc, S_loc, D): (output
    slice (B_loc, S_loc, D), aux fp32 0-d, the same on every rank).  params
    hold the rank's E / tp experts; `specs` (their specs, the shared
    expert's too) say which are FSDP-sharded over `data`."""
    tp = mesh.size(MODEL_AXIS)
    b, s, d = x.shape
    t_loc = b * s
    e_loc = n_experts // tp
    xf = x.reshape(t_loc, d)
    cdt = x.dtype

    # -- routing (the router is replicated over model: f sums its gradient) --
    router = _gathered(params, "router", specs, mesh)
    router = mesh_mod.f(router, mesh, MODEL_AXIS)
    probs, gate_vals, expert_ids = (t[0] for t in _route(router, xf[None], top_k))

    # aux load-balance loss over the global batch
    me = _global_mean(probs.mean(dim=0), mesh)
    ce = F.one_hot(expert_ids, n_experts).to(torch.float32).sum(1).mean(0) / top_k
    ce = _global_mean(ce, mesh).detach()
    aux = n_experts * torch.sum(me * ce)

    # -- bucket assignments by destination model rank -------------------------
    n_assign = t_loc * top_k
    flat_ids = expert_ids.reshape(n_assign)
    flat_gates = gate_vals.reshape(n_assign).to(cdt)
    token_of_assign = torch.arange(t_loc, device=x.device).repeat_interleave(top_k)
    dest = flat_ids // e_loc
    c_send = int(max(1, round(n_assign / tp * capacity_factor)))
    n_send = tp * c_send
    send_slot, send_valid = _count_dispatch(dest, tp, c_send)
    assign_of_slot, send_filled = _inverse(send_slot, n_send)
    payload = ToSlots.apply(xf, token_of_assign[assign_of_slot], send_filled,
                            send_slot.view(t_loc, top_k))
    local_eid = torch.where(send_valid, flat_ids % e_loc, e_loc)
    meta_eid = _scatter_rows(local_eid + 1, send_slot, n_send) - 1  # -1: empty row

    # -- all-to-all over the model axis -----------------------------------------
    if wire_dtype == "int8":
        recv = q8_all_to_all(payload, mesh, MODEL_AXIS)
    else:
        recv = mesh_mod.all_to_all(payload, mesh, MODEL_AXIS)
    recv_eid = mesh.all_to_all_tiled(meta_eid, MODEL_AXIS)
    n_recv = n_send

    # -- local dispatch to the E_loc experts --------------------------------------
    c_exp = int(max(1, round(n_recv / max(e_loc, 1) * capacity_factor)))
    n_exp = e_loc * c_exp
    eid = torch.where(recv_eid >= 0, recv_eid, e_loc)
    exp_slot, _ = _count_dispatch(eid, e_loc + 1, c_exp)
    exp_slot = torch.where(recv_eid >= 0, exp_slot, (e_loc + 1) * c_exp)
    row_of_slot, exp_filled = _inverse(exp_slot, (e_loc + 1) * c_exp)
    row_of_slot, exp_filled = row_of_slot[:n_exp], exp_filled[:n_exp]
    back_slot = torch.clamp(exp_slot, max=n_exp).view(n_recv, 1)  # n_exp: a zero row
    xe = ToSlots.apply(recv, row_of_slot, exp_filled, back_slot)

    # -- the FSDP weight gather over data, then the experts -----------------------
    wi = _gathered(params, "wi", specs, mesh, wire_dtype)
    wg = _gathered(params, "wg", specs, mesh, wire_dtype)
    wo = _gathered(params, "wo", specs, mesh, wire_dtype, scale_axis=1)  # gathered on D
    ye = _experts({"wi": wi.to(cdt), "wg": wg.to(cdt), "wo": wo.to(cdt)},
                  xe.view(e_loc, c_exp, d)).reshape(n_exp, d)

    # -- un-dispatch, the return all-to-all, the gated combine --------------------
    back = FromSlots.apply(ye, back_slot, row_of_slot, exp_filled)
    back = back.view(tp, c_send, d)
    if wire_dtype == "int8":
        returned = q8_all_to_all(back, mesh, MODEL_AXIS)
    else:
        returned = mesh_mod.all_to_all(back, mesh, MODEL_AXIS)
    returned = returned.reshape(n_send, d)
    inv = torch.where(send_filled, assign_of_slot, n_assign).view(n_send, 1)
    per_assign = ToSlots.apply(returned, torch.clamp(send_slot, max=n_send - 1), send_valid,
                               inv)
    per_assign = per_assign * (flat_gates * send_valid.to(cdt))[:, None]
    out = per_assign.view(t_loc, top_k, d).sum(1)
    return out.view(b, s, d), aux.to(torch.float32)


def apply_moe_a2a(mesh: Mesh, params: dict, x: torch.Tensor, *, top_k: int, n_experts: int,
                  capacity_factor: float = 1.25, wire_dtype: str = "native",
                  shared_ffn: Optional[int] = None, specs: Optional[dict] = None,
                  seq_sharded: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B_loc, S, D), this data rank's batch replicated over `model` ->
    (output, replicated over `model` as x; aux fp32 0-d); with seq_sharded,
    x is the rank's slice (B_loc, S / tp, D) of a residual sharded on its
    sequence (models/sharding_hook) and the output that slice's, as JAX's
    shard_map specs P(batch, model, None) take and give them.  params hold the
    rank's shards: router (D, E) whole, wi/wg (E / tp, D, F), wo (E / tp,
    F, D); with shared experts "shared" {"wi", "wg" (D, Fs / tp), "wo"
    (Fs / tp, D)}, column- and row-parallel when shared_ffn (the global Fs)
    is larger than the local width, else whole.  `specs`: the specs of
    params where any of them is FSDP-sharded over `data` (each such leaf
    then holds D / dp of its `embed` dim and is gathered before use).
    Needs S % tp == 0 (the full S) and E % tp == 0."""
    tp = mesh.size(MODEL_AXIS)
    b, s, d = x.shape
    s_full = s * tp if seq_sharded else s
    if s_full % tp or n_experts % tp:
        raise ValueError(f"apply_moe_a2a needs S ({s_full}) and E ({n_experts}) divisible by "
                         f"the model axis ({tp})")
    x_loc = x if seq_sharded else mesh_mod.split(x, mesh, MODEL_AXIS, 1)
    out, aux = moe_a2a_body(mesh, params, x_loc, top_k=top_k, n_experts=n_experts,
                            capacity_factor=capacity_factor, specs=specs,
                            wire_dtype=wire_dtype)
    if not seq_sharded:
        out = mesh_mod.gather(out, mesh, MODEL_AXIS, 1)
    if "shared" in params:
        sp = fsdp.gather_tree(params["shared"], None if specs is None else specs["shared"], mesh)
        if shared_ffn is not None and sp["wo"].shape[0] != shared_ffn:  # column, row-parallel
            if seq_sharded:
                part = _shared(sp, mesh_mod.all_gather(x, mesh, MODEL_AXIS, 1))
                out = out + mesh_mod.psum_scatter(part, mesh, MODEL_AXIS, 1)
            else:
                out = out + mesh_mod.g(_shared(sp, mesh_mod.f(x, mesh, MODEL_AXIS)), mesh,
                                       MODEL_AXIS)
        elif seq_sharded:  # whole weights on the slice: their gradients summed over `model`
            out = out + _shared({k: mesh_mod.f(v, mesh, MODEL_AXIS) for k, v in sp.items()}, x)
        else:
            out = out + _shared(sp, x)
    return out, aux
