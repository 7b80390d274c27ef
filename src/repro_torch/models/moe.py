"""Mixture-of-Experts FFN with grouped, capacity-based dispatch.

Port of src/repro/models/moe.py (`init_moe`, `apply_moe`, `moe_ref`), the
path the JAX block takes on one device, in every decode step and whenever
no mesh with a model axis is installed.  The expert-parallel all-to-all
path (`moe_a2a.py`) exchanges tokens between devices and has no meaning on
one card.

Semantics kept from the JAX function:
  * the T = B * S tokens split into g groups, g the largest divisor of T
    that is at most `n_groups`; each group of tg tokens dispatches alone;
  * the router's logits, softmax and top-k in fp32 (the router is
    upcast); the k gates renormalised to sum to 1, then cast to x's dtype;
  * the Switch load-balance loss E * sum_e(mean prob_e * routed share_e);
  * each expert takes cap = max(1, round(tg * k / E * capacity_factor))
    assignments a group, Python's `round` (half to even) on the host;
  * an assignment's position in its expert is a cumsum over the group's
    assignments laid out token-major, slot-minor; slot = expert * cap +
    position, and an assignment at or past cap is dropped;
  * an unfilled slot names token 0 with gate 0 and a zeroed input.
Every tensor on the path has a shape fixed by (g, tg, E, cap): no
`nonzero`, no boolean indexing, no host sync.

Dispatch and combine.  JAX gathers tokens into slots and scatter-adds the
gated expert outputs back into token rows.  A scatter-add on CUDA, and the
backward of a gather, add with atomics where one row is written several
times (a token is written by up to k slots), so their bits would change
from run to run.  Here both directions are gathers: `ToSlots` gathers each
slot's token (forward) and, in its backward, sums each token's k slot
gradients through the inverse map (the slot of each assignment, a dropped
one pointing at a zero pad row); `FromSlots` is its transpose.  A token's
k contributions are summed with `.sum` over a fixed axis, so every result
is deterministic.  At bf16 that reduction accumulates in fp32 and rounds
once, where XLA adds the bf16 terms in slot order; the difference shows
only at bf16, never in the fp32 parity tests.  The gates reach their slots
through the same pair of Functions, so the router's gradient through the
gates is a gather too.

Internally the slots are laid out expert-major over the whole batch (slot
(expert, group, position) at ((expert * g + group) * cap + position)), so
the expert FFN is one batched GEMM over (E, g * cap) rows with no
transpose; `tables` returns them in the JAX layout, (g, E * cap) per group.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init


def init_moe(gen: torch.Generator, d_model: int, d_ff: int, n_experts: int, *,
             n_shared: int = 0, dtype: torch.dtype = torch.float32, lead=()) -> dict:
    """MoE params (with optional leading layer dims) in the JAX layouts:
    router (D, E), wi/wg (E, D, F), wo (E, F, D); with shared experts a
    "shared" SwiGLU MLP of width n_shared * F."""
    p = {
        "router": dense_init(gen, (*lead, d_model, n_experts), dtype, fan_in=d_model),
        "wi": dense_init(gen, (*lead, n_experts, d_model, d_ff), dtype, fan_in=d_model),
        "wg": dense_init(gen, (*lead, n_experts, d_model, d_ff), dtype, fan_in=d_model),
        "wo": dense_init(gen, (*lead, n_experts, d_ff, d_model), dtype, fan_in=d_ff),
    }
    if n_shared:
        fs = n_shared * d_ff
        p["shared"] = {
            "wi": dense_init(gen, (*lead, d_model, fs), dtype, fan_in=d_model),
            "wg": dense_init(gen, (*lead, d_model, fs), dtype, fan_in=d_model),
            "wo": dense_init(gen, (*lead, fs, d_model), dtype, fan_in=fs),
        }
    return p


def n_groups_for(t: int, n_groups: int) -> int:
    """The largest divisor of t that is at most n_groups (JAX's loop)."""
    g = min(n_groups, t)
    while t % g:
        g -= 1
    return g


def capacity(tg: int, top_k: int, n_experts: int, capacity_factor: float) -> int:
    """Assignments an expert takes a group: the JAX expression, Python's
    round (half to even) included."""
    return int(max(1, round(tg * top_k / n_experts * capacity_factor)))


# ---------------------------------------------------------------------------
# Routing and the dispatch tables
# ---------------------------------------------------------------------------


def _route(router: torch.Tensor, xg: torch.Tensor, top_k: int):
    """fp32 router: (probs (g, tg, E), renormalised gates (g, tg, k),
    expert ids (g, tg, k))."""
    logits = xg.float() @ router.float()
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_ids = torch.topk(probs, top_k, dim=-1)
    return probs, _renormalise(gate_vals), expert_ids


def _renormalise(gate_vals: torch.Tensor) -> torch.Tensor:
    return gate_vals / gate_vals.sum(dim=-1, keepdim=True)


def _positions(flat_ids: torch.Tensor, n_experts: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(position of each assignment in its expert (g, tg * k), assignments
    per expert (g, E)): the cumsum over the group's assignments in their
    token-major, slot-minor order."""
    onehot = F.one_hot(flat_ids, n_experts).to(torch.int32)
    running = torch.cumsum(onehot, dim=1, dtype=torch.int32)  # (g, tg * k, E)
    pos = torch.gather(running, 2, flat_ids[..., None])[..., 0] - 1
    return pos, running[:, -1, :]


def _slots(flat_ids: torch.Tensor, pos: torch.Tensor, cap: int, n_experts: int) -> torch.Tensor:
    """Each assignment's slot in its group, expert * cap + position, or
    E * cap (the pad: dropped) at or past the capacity."""
    return torch.where(pos < cap, flat_ids * cap + pos, n_experts * cap)


def dispatch_tables(expert_ids: torch.Tensor, gate_vals: torch.Tensor, cap: int,
                    n_experts: int) -> Dict[str, torch.Tensor]:
    """The dispatch of one layer from its routing (g, tg, k), in the JAX
    layout: "slot" (g, tg * k) int64 (E * cap where dropped),
    "assignment_of_slot" (g, E * cap) int64 (0 where unfilled),
    "token_of_slot" (its token), "filled" (g, E * cap) bool, "gate_of_slot"
    (g, E * cap) in gate_vals' dtype (0 where unfilled), "routed" (g, E)
    assignments per expert before the capacity."""
    g, tg, k = expert_ids.shape
    n_slots = n_experts * cap
    flat_ids = expert_ids.reshape(g, tg * k)
    pos, routed = _positions(flat_ids, n_experts)
    slot = _slots(flat_ids, pos, cap, n_experts)
    # Valid slots are distinct; every dropped assignment writes the pad column.
    assign = torch.arange(tg * k, device=slot.device).expand(g, -1)
    assignment_of_slot = torch.zeros(g, n_slots + 1, dtype=torch.int64, device=slot.device)
    assignment_of_slot.scatter_(1, slot, assign)
    filled = torch.zeros(g, n_slots + 1, dtype=torch.bool, device=slot.device)
    filled.scatter_(1, slot, torch.ones_like(slot, dtype=torch.bool))
    assignment_of_slot, filled = assignment_of_slot[:, :n_slots], filled[:, :n_slots]
    gate_flat = gate_vals.reshape(g, tg * k)
    gate_of_slot = torch.where(filled, torch.gather(gate_flat, 1, assignment_of_slot),
                               torch.zeros((), dtype=gate_vals.dtype, device=slot.device))
    return {"slot": slot, "assignment_of_slot": assignment_of_slot,
            "token_of_slot": assignment_of_slot // k, "filled": filled,
            "gate_of_slot": gate_of_slot, "routed": routed}


def _expert_major(tables: dict, cap: int, n_experts: int, tg: int, k: int):
    """The tables over the whole batch with expert-major slots: (global
    slot of each assignment (T * k,), pad S = E * g * cap; global
    assignment of each slot (S,); its global token (S,); filled (S,))."""
    slot, filled = tables["slot"], tables["filled"]
    g = slot.shape[0]
    n_slots = n_experts * g * cap
    group = torch.arange(g, device=slot.device)[:, None]
    gslot = torch.where(slot < n_experts * cap,
                        (slot // cap * g + group) * cap + slot % cap, n_slots).reshape(-1)

    def em(t):  # (g, E * cap) -> (E * g * cap,), slot (e, group, c) first by expert
        return t.view(g, n_experts, cap).transpose(0, 1).reshape(-1)

    assignment = em(tables["assignment_of_slot"] + group * (tg * k))
    return gslot, assignment, assignment // k, em(filled)


# ---------------------------------------------------------------------------
# Dispatch and combine: gathers both ways
# ---------------------------------------------------------------------------


def _gather_rows(x: torch.Tensor, src: torch.Tensor, filled: torch.Tensor) -> torch.Tensor:
    """y[s] = x[src[s]] where filled[s], else 0: x (N, D) -> (S, D)."""
    return x.index_select(0, src).masked_fill(~filled[:, None], 0)


def _sum_rows(y: torch.Tensor, inv: torch.Tensor) -> torch.Tensor:
    """out[i] = sum_r y[inv[i, r]], with inv = S naming a zero pad row:
    y (S, D), inv (N, r) -> (N, D); the r terms summed over a fixed axis."""
    padded = torch.cat([y, y.new_zeros(1, y.shape[1])])
    return padded.index_select(0, inv.reshape(-1)).view(*inv.shape, y.shape[1]).sum(1)


class ToSlots(torch.autograd.Function):
    """y (S, D) = rows of x (N, D) gathered into slots (src, filled); the
    backward sums each row's slot gradients through inv (N, r), the slots
    of row i (S for none)."""

    @staticmethod
    def forward(ctx, x, src, filled, inv):
        ctx.save_for_backward(src, filled, inv)
        return _gather_rows(x, src, filled)

    @staticmethod
    def backward(ctx, dy):
        src, filled, inv = ctx.saved_tensors
        return _sum_rows(dy, inv), None, None, None


class FromSlots(torch.autograd.Function):
    """out (N, D) = for each row the sum of its slots' rows of y (S, D)
    (inv (N, r)); the backward gathers each slot's row gradient (src,
    filled).  The transpose of ToSlots."""

    @staticmethod
    def forward(ctx, y, inv, src, filled):
        ctx.save_for_backward(inv, src, filled)
        return _sum_rows(y, inv)

    @staticmethod
    def backward(ctx, dout):
        inv, src, filled = ctx.saved_tensors
        return _gather_rows(dout, src, filled), None, None, None


def _experts(params: dict, xe: torch.Tensor) -> torch.Tensor:
    """The SwiGLU expert FFN over expert-major slots, xe (E, rows, D): three
    batched GEMMs."""
    h = F.silu(torch.bmm(xe, params["wg"])) * torch.bmm(xe, params["wi"])
    return torch.bmm(h, params["wo"])


def _shared(sp: dict, x: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ sp["wg"]) * (x @ sp["wi"])) @ sp["wo"]


# ---------------------------------------------------------------------------
# The layer
# ---------------------------------------------------------------------------


def apply_moe(params: dict, x: torch.Tensor, *, top_k: int, n_groups: int,
              capacity_factor: float = 1.25, return_tables: bool = False):
    """x (B, S, D) -> (output (B, S, D), aux load-balance loss, fp32 0-d);
    with return_tables also the dispatch (`dispatch_tables`, plus "cap",
    "expert_ids" (g, tg, k) and "gate_vals" (g, tg, k) fp32)."""
    b, s, d = x.shape
    e = params["router"].shape[-1]
    xf = x.reshape(-1, d)
    t = xf.shape[0]
    g = n_groups_for(t, n_groups)
    tg = t // g
    probs, gate_vals, expert_ids = _route(params["router"], xf.view(g, tg, d), top_k)
    cap = capacity(tg, top_k, e, capacity_factor)
    tables = dispatch_tables(expert_ids, gate_vals.to(x.dtype), cap, e)

    # Switch load balance: E * sum_e(mean prob_e * share of assignments_e).
    share = tables["routed"].sum(0).float() / (g * tg) / top_k
    aux = e * torch.sum(probs.mean(dim=(0, 1)) * share)

    gslot, assignment, token, filled = _expert_major(tables, cap, e, tg, top_k)
    xe = ToSlots.apply(xf, token, filled, gslot.view(t, top_k))
    gates = ToSlots.apply(gate_vals.to(x.dtype).reshape(t * top_k, 1), assignment, filled,
                          gslot.view(t * top_k, 1))
    ye = _experts(params, xe.view(e, g * cap, d)).view(-1, d) * gates
    out = FromSlots.apply(ye, gslot.view(t, top_k), token, filled).view(b, s, d)
    if "shared" in params:
        out = out + _shared(params["shared"], x)
    if return_tables:
        return out, aux, {**tables, "cap": cap, "expert_ids": expert_ids,
                          "gate_vals": gate_vals}
    return out, aux


def moe_ref(params: dict, x: torch.Tensor, *, top_k: int) -> torch.Tensor:
    """Dense per-token reference: every expert for every token, (T, E, F)
    of h (tests and checks only)."""
    b, s, d = x.shape
    xf = x.reshape(-1, d)
    probs = torch.softmax(xf.float() @ params["router"].float(), dim=-1)
    gate_vals, expert_ids = torch.topk(probs, top_k, dim=-1)
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)
    h = F.silu(torch.einsum("td,edf->tef", xf, params["wg"])) * torch.einsum(
        "td,edf->tef", xf, params["wi"])
    ye = torch.einsum("tef,efd->ted", h, params["wo"])
    gates = torch.zeros_like(probs).scatter(1, expert_ids, gate_vals)
    out = torch.einsum("ted,te->td", ye, gates.to(ye.dtype))
    if "shared" in params:
        out = out + _shared(params["shared"], xf)
    return out.reshape(b, s, d)
