"""Module-level mesh hook: how the model code reaches its collectives.

Port of src/repro/models/sharding_hook.py.  The runtime
(runtime/steps.py, or `model.loss_fn(..., mesh=...)`) installs the mesh of
a sharded run before the forward; the model code asks `current_mesh()` and
calls the tensor-parallel collectives through `enter_model` (Megatron's f:
identity forward, psum over `model` backward) and `leave_model` (g: psum
forward, identity backward).  With no mesh installed, or a `model` axis
of one rank, every hook is the identity: the 1x1 path's arithmetic and
launches do not change.

The JAX side's `shard(x, kind)` (with_sharding_constraint) has no
counterpart: the port fixes every activation's layout in the code that
makes it (the residual replicated over `model`).

A layer rematerialised under torch.utils.checkpoint runs its forward again
in the backward, after the installing call has returned: `bind` wraps a
function so that it runs with the mesh that was installed when it was
bound.
"""

from __future__ import annotations

import contextlib
import functools

from repro_torch.runtime import mesh as mesh_mod

MODEL_AXIS = mesh_mod.MODEL_AXIS
_MESH = [None]


def set_hook(mesh) -> None:
    _MESH[0] = mesh


def clear_hook() -> None:
    _MESH[0] = None


def current_mesh():
    """The mesh the runtime installed (None on the one-device path)."""
    return _MESH[0]


@contextlib.contextmanager
def installed(mesh):
    """Install `mesh` for the body (nothing changes for mesh None)."""
    saved = _MESH[0]
    if mesh is not None:
        _MESH[0] = mesh
    try:
        yield mesh
    finally:
        _MESH[0] = saved


def bind(fn):
    """fn, run under the mesh installed now (for a remat's recompute)."""
    mesh = current_mesh()
    if mesh is None:
        return fn

    @functools.wraps(fn)
    def run(*args, **kwargs):
        with installed(mesh):
            return fn(*args, **kwargs)

    return run


def model_size() -> int:
    """Ranks on the installed mesh's `model` axis (1 with no mesh)."""
    mesh = current_mesh()
    return 1 if mesh is None else mesh.size(MODEL_AXIS)


def model_index() -> int:
    mesh = current_mesh()
    return 0 if mesh is None else mesh.index(MODEL_AXIS)


def enter_model(x):
    """Megatron's f over `model` (identity without a mesh)."""
    mesh = current_mesh()
    return x if mesh is None else mesh_mod.f(x, mesh, MODEL_AXIS)


def leave_model(x):
    """Megatron's g over `model` (identity without a mesh)."""
    mesh = current_mesh()
    return x if mesh is None else mesh_mod.g(x, mesh, MODEL_AXIS)
