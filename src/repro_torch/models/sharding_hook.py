"""Module-level mesh hook: how the model code reaches its collectives.

Port of src/repro/models/sharding_hook.py and of the activation hook that
src/repro/runtime/steps.install_activation_sharding installs.  The
runtime (runtime/steps.py, or `model.loss_fn(..., mesh=...)`) installs
the mesh of a sharded run and its sharding rules before the forward; the
model code asks `current_mesh()` and calls the tensor-parallel
collectives through `enter_model` (Megatron's f: identity forward, psum
over `model` backward) and `leave_model` (g: psum forward, identity
backward).  With no mesh installed, or a `model` axis of one rank, every
hook is the identity: the 1x1 path's arithmetic and launches do not
change.

The JAX side's `shard(h, "residual")` (with_sharding_constraint) lays the
residual stream (B, S, D) out with its batch over the data axes and its
sequence over `model` wherever the rules map "seq" there and the model
axis divides S (runtime/sharding.residual_seq_axis).  Here the model's
entry points decide that layout for each forward from its full S
(`residual(seq_len, rules)`: the installed rules, else the model's
rules_for(cfg)), and the layers realise it as Megatron's sequence
parallelism: between blocks a rank holds the positions [r S/tp, (r+1)
S/tp) of its `model` index r; the norm and the residual add run on that
slice; `column_in` is the all-gather of the sequence before a
column-parallel product (backward: psum-scatter) in place of f, and
`row_out` the psum-scatter after a row-parallel one (backward:
all-gather) in place of g.  A computation that every model rank repeats
on the whole sequence (an unsharded MLP or head, the MoE router) takes
the sequence through `seq_whole` (all-gather, backward: the rank's
slice) and gives it back through `seq_part` (the rank's slice, backward:
all-gather), and a replicated weight applied to the slice alone (the
norms' scales) through `seq_shared` (f: its gradient summed over the
ranks' parts).  With the residual replicated (decode's S = 1, an S the
axis does not divide, rules mapping "seq" to None), `seq_whole`,
`seq_part` and `seq_shared` are the identity and `column_in` /
`row_out` are f / g: Megatron's tensor parallelism on a replicated
residual.  The head-parallel Mamba2 and mLSTM mixers (models/ssm.py,
models/xlstm.py) reach their own collectives here too: `model_sum` (a
norm's sum of squares over the ranks' channels, psum both ways),
`model_all_gather` (Mamba2's convolved B and C), `head_scatter` (the mLSTM
gates' partial sums onto the rank's heads) and `model_part` (a replicated
bias on the rank's heads).

A layer rematerialised under torch.utils.checkpoint runs its forward again
in the backward, after the installing call has returned: `bind` wraps a
function so that it runs with the mesh, the rules and the layout that
were installed when it was bound.
"""

from __future__ import annotations

import contextlib
import functools

from repro_torch.runtime import mesh as mesh_mod
from repro_torch.runtime.sharding import residual_seq_axis

MODEL_AXIS = mesh_mod.MODEL_AXIS
# The installed mesh, its rules (None: the model's own, rules_for(cfg)),
# and whether the residual of the running forward is sharded on its
# sequence over `model`.
_STATE = {"mesh": None, "rules": None, "seq": False}


def set_hook(mesh, rules=None) -> None:
    _STATE.update(mesh=mesh, rules=rules, seq=False)


def clear_hook() -> None:
    _STATE.update(mesh=None, rules=None, seq=False)


def current_mesh():
    """The mesh the runtime installed (None on the one-device path)."""
    return _STATE["mesh"]


@contextlib.contextmanager
def installed(mesh, rules=None):
    """Install `mesh` and its `rules` (None: the model's rules_for(cfg)) for
    the body, the residual replicated until a forward decides its layout
    (mesh None: whatever is installed stays)."""
    saved = dict(_STATE)
    if mesh is not None:
        set_hook(mesh, rules)
    try:
        yield mesh
    finally:
        _STATE.update(saved)


@contextlib.contextmanager
def residual(seq_len: int, rules):
    """The residual's layout for a forward over seq_len positions (the full
    length), decided by the installed rules, or `rules` (the model's
    rules_for(cfg)) where none were installed (sharding.residual_seq_axis):
    sharded on its sequence over `model`, or replicated.  Yields the
    decision."""
    saved = _STATE["seq"]
    mesh = _STATE["mesh"]
    _STATE["seq"] = mesh is not None and residual_seq_axis(
        mesh, _STATE["rules"] or rules, seq_len) is not None
    try:
        yield _STATE["seq"]
    finally:
        _STATE["seq"] = saved


def bind(fn):
    """fn, run under the mesh, rules and layout installed now (for a
    remat's recompute)."""
    if _STATE["mesh"] is None:
        return fn
    state = dict(_STATE)

    @functools.wraps(fn)
    def run(*args, **kwargs):
        saved = dict(_STATE)
        _STATE.update(state)
        try:
            return fn(*args, **kwargs)
        finally:
            _STATE.update(saved)

    return run


def model_size() -> int:
    """Ranks on the installed mesh's `model` axis (1 with no mesh)."""
    mesh = current_mesh()
    return 1 if mesh is None else mesh.size(MODEL_AXIS)


def model_index() -> int:
    mesh = current_mesh()
    return 0 if mesh is None else mesh.index(MODEL_AXIS)


def seq_parallel() -> bool:
    """Whether the running forward's residual is sharded on its sequence."""
    return _STATE["seq"]


def enter_model(x):
    """Megatron's f over `model` (identity without a mesh)."""
    mesh = current_mesh()
    return x if mesh is None else mesh_mod.f(x, mesh, MODEL_AXIS)


def leave_model(x):
    """Megatron's g over `model` (identity without a mesh)."""
    mesh = current_mesh()
    return x if mesh is None else mesh_mod.g(x, mesh, MODEL_AXIS)


def column_in(x):
    """The residual into a column-parallel product: the rank's slice
    (B, S/tp, ...) all-gathered over `model` on dim 1 (backward:
    psum-scatter), or f where the residual is replicated."""
    if seq_parallel():
        return mesh_mod.all_gather(x, current_mesh(), MODEL_AXIS, 1)
    return enter_model(x)


def row_out(x):
    """A row-parallel product's partial sums back to the residual's layout:
    the rank's slice of their sum over `model` (psum-scatter on dim 1;
    backward: all-gather), or g where the residual is replicated."""
    if seq_parallel():
        return mesh_mod.psum_scatter(x, current_mesh(), MODEL_AXIS, 1)
    return leave_model(x)


def seq_whole(x):
    """The rank's slice -> the whole sequence for a computation that every
    model rank repeats (backward: the rank's slice of the replicated
    gradient); the identity where the residual is replicated."""
    return mesh_mod.gather(x, current_mesh(), MODEL_AXIS, 1) if seq_parallel() else x


def seq_part(x):
    """The whole sequence, replicated over `model` -> the rank's slice
    (backward: all-gather); the identity where the residual is
    replicated."""
    return mesh_mod.split(x, current_mesh(), MODEL_AXIS, 1) if seq_parallel() else x


def model_sum(x):
    """The sum over `model` of each rank's part of a quantity that every
    rank then uses on its own channels (a norm's sum of squares over a
    channel dim the ranks split): psum forward AND backward (f of g), since
    each rank's loss reaches the total through its own channels, so the
    total's cotangent is the sum of every rank's.  g alone (identity
    backward) would keep the rank's own part of it.  The identity without a
    mesh."""
    return enter_model(leave_model(x))


def model_all_gather(x, dim: int):
    """Every model rank's x concatenated on `dim` (backward: the rank's
    chunk of the summed gradient, a psum-scatter); the identity without a
    mesh."""
    mesh = current_mesh()
    return x if mesh is None else mesh_mod.all_gather(x, mesh, MODEL_AXIS, dim)


def head_scatter(x, dim: int):
    """Partial sums that every model rank holds for every head (a product
    that contracts over channels the ranks split) -> the rank's heads of
    their sum, cut on `dim` (a psum-scatter; backward: the all-gather of
    the heads' gradients, since each rank's partial reaches every head).
    The identity without a mesh."""
    mesh = current_mesh()
    return x if mesh is None else mesh_mod.psum_scatter(x, mesh, MODEL_AXIS, dim)


def model_part(t):
    """The rank's chunk of a vector replicated over `model` that the rank
    applies to its part only (an mLSTM's forget bias on the rank's heads):
    through f first, so its gradient is summed over the ranks' chunks.  As
    it is without a mesh."""
    n = model_size()
    if n == 1:
        return t
    c = t.shape[0] // n
    return enter_model(t).narrow(0, model_index() * c, c)


def seq_shared(params: dict) -> dict:
    """A dict of replicated weights that each rank applies to its slice of
    the sequence only (a norm's scale): f on each, so their gradients are
    summed over the ranks' parts; as it is where the residual is
    replicated."""
    if not seq_parallel():
        return params
    return {k: enter_model(v) for k, v in params.items()}
