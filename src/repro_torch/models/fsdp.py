"""The gather of FSDP-sharded weights before use.

The counterpart of GSPMD's all-gather of a weight whose `embed` dim the
sharding rules put on `data` (cfg.fsdp_embed: src/repro/runtime/sharding.py
maps "embed" to "data"; JAX's serve and train CLIs shard the params by
those rules, so XLA gathers each such weight before the op that reads
it).  A rank holds D / dp of the embed dim of every such leaf; `gather`
all-gathers it over `data` on that dim (runtime/mesh.all_gather, whose
backward is the psum_scatter: each data rank's gradient of the whole
weight summed, and this rank's chunk kept; runtime/steps then divides it
by dp, `_average_over_data`).

Which dims to gather is read from the leaf's spec (model.param_specs:
`model.param_axes` under `sharding.rules_for`), never from its shape: a
dim whose spec part is `data` is gathered.  With no mesh installed
(models/sharding_hook), a `data` axis of one rank, or a spec without
`data`, `gather` returns the tensor itself: the 1x1 path's arithmetic and
launches do not change.

Where it runs (models/model.py, transformer.py, moe_a2a.py): once a layer
at the entry of `transformer.apply_block`, `prefill_block` and
`decode_block`, which `model._remat` checkpoints in training, so a
layer's gathered weights are freed after its forward and gathered again
in its recompute (a rank never holds more than one layer whole); on the
embedding table before `layers.embed` and the tied `layers.unembed`, and
on the untied head.  An MoE layer's experts, router and shared expert are
gathered inside the MoE FFN: on the all-to-all path by models/moe_a2a
(after the dispatch, with its int8 wire when cfg.moe_wire_dtype is
"int8": `q8_all_gather`), on the capacity dispatch there.  The params are
gathered as the entry points walk them, after `model.cast_params`: in the
compute dtype, so the forward gets the same bits as a gather of the fp32
master and a cast, at half the wire bytes in bf16, and the gradient's
psum_scatter sums the compute dtype's cotangents (runtime/mesh.psum: a
bf16 sum over two ranks is the fp32 sum rounded once; over more it sums
in fp32 and rounds once).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.models import sharding_hook as hook
from repro_torch.runtime import mesh as mesh_mod
from repro_torch.runtime.mesh import DATA_AXIS

AllGather = Callable[[torch.Tensor, "mesh_mod.Mesh", str, int], torch.Tensor]


def data_dims(spec) -> tuple:
    """The dims of a leaf that its spec shards over `data`."""
    return tuple(dim for dim, part in enumerate(spec) if part == DATA_AXIS)


def any_sharded(specs) -> bool:
    """Whether any leaf of a spec tree is sharded over `data`."""
    if isinstance(specs, dict):
        return any(any_sharded(s) for s in specs.values())
    return bool(data_dims(specs))


def gather(t: torch.Tensor, spec, mesh=None,
           all_gather: AllGather = mesh_mod.all_gather) -> torch.Tensor:
    """t whole on every dim its spec shards over `data` (mesh: the installed
    one when None).  `all_gather(x, mesh, axis, dim)` moves it
    (moe_a2a passes its int8 wire)."""
    mesh = hook.current_mesh() if mesh is None else mesh
    if mesh is None or mesh.size(DATA_AXIS) == 1:
        return t
    for dim in data_dims(spec):
        t = all_gather(t, mesh, DATA_AXIS, dim)
    return t


def gather_tree(tree: dict, specs: Optional[dict], mesh=None, skip=()) -> dict:
    """Every leaf of a params tree through `gather` by its spec (specs None:
    the tree itself); the entries named in `skip` are left as they are."""
    if specs is None:
        return tree
    return {k: v if k in skip else
            gather_tree(v, specs[k], mesh) if isinstance(v, dict) else gather(v, specs[k], mesh)
            for k, v in tree.items()}
