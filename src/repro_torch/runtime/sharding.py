"""Logical-axis -> mesh-axis sharding rules, and cutting tensors to shards.

Port of src/repro/runtime/sharding.py.  Parameters carry logical axis
names (`model.param_axes(cfg)`); the rules map them to mesh axes, with the
same divisibility fallback (a dimension shards only if it divides the mesh
axis, else a shorter prefix of a tuple assignment, else not at all) and the
same first-come guard (no mesh axis twice in one spec).  A spec here is a
tuple with one entry per dim: None, a mesh axis name, or a tuple of them
(what `tuple(PartitionSpec)` gives on the JAX side).

Default rules (as the JAX package's):
  TP over `model`: heads / kv_heads / ffn / vocab / experts / ssm dims;
  FSDP over `data`: the `embed` axis when cfg.fsdp_embed;
  DP over `pod` + `data`: the batch axis of activations and caches;
  SP over `model`: the seq axis of the residual (training and prefill)
  and of KV caches (decode); `seq` and `kv_seq` name no parameter.

`residual_seq_axis` decides the residual stream's layout as JAX's
`install_activation_sharding` does (src/repro/runtime/steps.py:37-89):
its sequence over the rules' "seq" axis where that axis is in the mesh
and divides the FULL sequence length (`_fit`), else replicated
(models/sharding_hook acts on the decision).

A decode cache (B, max_len, Hkv, Dh) carries JAX's CACHE_AXES (batch,
kv_seq, kv_heads, None): `cache_spec` resolves them with the same guards,
so `model` goes to the sequence when max_len divides it, else to the kv
heads when n_kv does, else to neither (the cache replicated over `model`).

`shard_tensor` / `shard_tree` cut a global tensor or tree to this rank's
shard (a copy of the slice); `unshard_tensor` / `unshard_tree` gather the
shards back to the whole (a collective over the spec's axes: every rank of
the mesh calls it).

A fused leaf whose dim concatenates parts that a tensor-parallel layer
needs cut one by one (Mamba2's in_proj columns [z | x | B | C | dt], its
convolution's channels [x | B | C]: models/ssm.segments, the one segment
table) names that dim's logical axis as a `Segmented` name, which carries
the parts' lengths.  `spec_for_axes` gives such a dim a `Segmented` mesh
axis (a str equal to the plain axis name, so the spec still equals
JAX's), and every cut and gather by spec (`shard_tensor`,
`unshard_tensor`: the runtime's params and optimizer state, the
checkpoint manager, the serve path) holds 1/n of EACH segment on a rank,
in segment order, where a contiguous cut would give the first ranks
whole segments.  Which elements a shard holds changes; the whole tensor
(and so a checkpoint, written whole) does not.  A segment that the axis
does not divide raises NotImplementedError naming it.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Union

import torch

from repro_torch.pytree import leaves, unflatten
from repro_torch.runtime.mesh import DATA_AXIS, MODEL_AXIS, POD_AXIS, Mesh, axis_sizes

AxisAssign = Union[None, str, Tuple[str, ...]]
Spec = Tuple[AxisAssign, ...]


class Segmented(str):
    """An axis name (logical, or the mesh axis a spec gives it) whose dim is
    the concatenation of `segments` (their lengths, in order; given as a
    {name: length} table, their `names` too, else their indices); equal
    to, and hashed as, the plain name."""

    segments: Tuple[int, ...]
    names: Tuple[str, ...]

    def __new__(cls, name: str, segments, names: Optional[Sequence[str]] = None):
        obj = super().__new__(cls, name)
        if isinstance(segments, dict):
            names, segments = tuple(segments), tuple(segments.values())
        obj.segments = tuple(int(n) for n in segments)
        obj.names = tuple(names) if names is not None else tuple(
            str(i) for i in range(len(obj.segments)))
        return obj

    def __reduce__(self):
        return Segmented, (str(self), self.segments, self.names)

    def __repr__(self) -> str:
        return f"Segmented({str(self)!r}, {dict(zip(self.names, self.segments))})"


def segment_chunk(t: torch.Tensor, dim: int, part: Segmented, idx: int,
                  n: int) -> torch.Tensor:
    """Part idx of n of every segment of t's `dim` (`part`'s), concatenated
    in segment order; check_segments first, so no cut is ever uneven."""
    check_segments(part, n)
    parts, at = [], 0
    for seg in part.segments:
        c = seg // n
        parts.append(t.narrow(dim, at + idx * c, c))
        at += seg
    return torch.cat(parts, dim)


def segment_join(chunks: Sequence[torch.Tensor], dim: int,
                 segments: Sequence[int]) -> torch.Tensor:
    """The inverse of segment_chunk: the whole dim from every part's chunk
    (in part order)."""
    n = len(chunks)
    pieces = [list(c.split([seg // n for seg in segments], dim)) for c in chunks]
    return torch.cat([pieces[j][i] for i in range(len(segments)) for j in range(n)], dim)


def check_segments(part: Segmented, n: int, what: str = "") -> None:
    """NotImplementedError naming the first of `part`'s segments that n
    does not divide (the one divisibility check of a segmented cut)."""
    for name, seg in zip(part.names, part.segments):
        if seg % n:
            raise NotImplementedError(
                f"{what}segment {name} of {part.segments} ({seg}) does not split over {n} "
                f"ranks: the port cuts a fused leaf segment by segment, never otherwise")


def default_rules(fsdp_embed: bool = False) -> Dict[str, AxisAssign]:
    return {
        # parameters
        "vocab": MODEL_AXIS,
        "heads": MODEL_AXIS,
        "kv_heads": MODEL_AXIS,
        "ffn": MODEL_AXIS,
        "ffn_out": None,
        "experts": MODEL_AXIS,
        "expert_ffn": None,
        "embed": DATA_AXIS if fsdp_embed else None,
        "embed_out": None,
        "ssm_inner": MODEL_AXIS,
        "ssm_heads": MODEL_AXIS,
        # activations / caches
        "batch": (POD_AXIS, DATA_AXIS),
        "kv_seq": MODEL_AXIS,
        "seq": MODEL_AXIS,
    }


def rules_for(cfg, overrides: Optional[Dict[str, AxisAssign]] = None) -> Dict[str, AxisAssign]:
    r = default_rules(getattr(cfg, "fsdp_embed", False))
    if overrides:
        r.update(overrides)
    return r


def _prod(sizes: Dict[str, int], axes: Sequence[str]) -> int:
    out = 1
    for a in axes:
        out *= sizes[a]
    return out


def residual_seq_axis(mesh, rules: Dict[str, AxisAssign], seq_len: int) -> Optional[str]:
    """The mesh axis that the residual (B, S, D) of a forward over seq_len
    positions shards its sequence over, or None (replicated): JAX's `_fit`
    for the activation axis "seq" (src/repro/runtime/steps.py:55-64), on
    the full S: the rules' "seq" axes (`model` where the rules do not name
    it) present in the mesh, dropped from the front until their product
    divides S; None where none is left or the product is 1.  `mesh` is a
    Mesh or a {axis: size} dict.  The port shards the residual over
    `model` only: any other axis left raises NotImplementedError."""
    sizes = axis_sizes(mesh)
    assign = rules.get("seq", MODEL_AXIS)
    axes = () if assign is None else (assign,) if isinstance(assign, str) else tuple(assign)
    axes = tuple(a for a in axes if a in sizes)
    while axes and seq_len % _prod(sizes, axes):
        axes = axes[1:]
    if _prod(sizes, axes) == 1:
        return None
    if axes != (MODEL_AXIS,):
        raise NotImplementedError(f"the residual's sequence over {axes}: the port shards it "
                                  f"over {MODEL_AXIS!r} only")
    return MODEL_AXIS


def spec_for_axes(mesh, axes: Sequence[Optional[str]], shape: Optional[Sequence[int]],
                  rules: Dict[str, AxisAssign]) -> Spec:
    """The spec of one tensor from its logical axes (and its global shape
    for the divisibility checks; None skips them).  `mesh` is a Mesh or a
    {axis: size} dict."""
    sizes = axis_sizes(mesh)
    used = set()
    parts = []
    for i, name in enumerate(axes):
        assign = rules.get(name) if name is not None else None
        if assign is None:
            parts.append(None)
            continue
        cand = (assign,) if isinstance(assign, str) else tuple(assign)
        cand = tuple(a for a in cand if a in sizes and a not in used)
        if not cand:
            parts.append(None)
            continue
        if shape is not None and shape[i] % _prod(sizes, cand) != 0:
            # try progressively shorter prefixes of the tuple
            ok = None
            for j in range(len(cand) - 1, 0, -1):
                if shape[i] % _prod(sizes, cand[:j]) == 0:
                    ok = cand[:j]
                    break
            if ok is None:
                parts.append(None)
                continue
            cand = ok
        used.update(cand)
        if isinstance(name, Segmented):  # one mesh axis, cut segment by segment
            if len(cand) > 1:
                raise NotImplementedError(
                    f"axis {str(name)!r} is cut segment by segment over one mesh axis; the "
                    f"rules give it {cand}, and a cut over several would be contiguous")
            check_segments(name, sizes[cand[0]], f"axis {str(name)!r}: ")
            parts.append(Segmented(cand[0], name.segments, name.names))
            continue
        parts.append(cand if len(cand) > 1 else cand[0])
    return tuple(parts)


# JAX's CACHE_AXES (src/repro/models/attention.py:233-240): kv_seq ahead
# of kv_heads, so the first-come guard gives `model` to the sequence first.
CACHE_AXES = ("batch", "kv_seq", "kv_heads", None)


def cache_spec(cfg, mesh, batch: int, max_len: int,
               rules: Optional[Dict[str, AxisAssign]] = None) -> Spec:
    """The spec of one layer's K or V cache (B, max_len, Hkv, Dh) on `mesh`
    (a Mesh or a {axis: size} dict), from the global shape."""
    shape = (batch, max_len, cfg.n_kv_heads, cfg.resolved_head_dim)
    return spec_for_axes(mesh, CACHE_AXES, shape, rules or rules_for(cfg))


def batch_spec(mesh, rules: Dict[str, AxisAssign]) -> Spec:
    """The spec of (B, ...) model inputs' leading dim: the DP axes."""
    assign = rules.get("batch", (POD_AXIS, DATA_AXIS))
    cand = (assign,) if isinstance(assign, str) else tuple(assign)
    sizes = axis_sizes(mesh)
    cand = tuple(a for a in cand if a in sizes)
    return (cand if len(cand) > 1 else (cand[0] if cand else None),)


def replicated() -> Spec:
    """The spec of a tensor every rank holds whole (JAX's P())."""
    return ()


def spec_axes(spec: Spec) -> Tuple[str, ...]:
    """The mesh axes a spec shards over, in order."""
    out = []
    for part in spec:
        if part is not None:
            out.extend((part,) if isinstance(part, str) else part)
    return tuple(out)


def tree_specs(mesh, axes_tree, shape_tree, rules: Dict[str, AxisAssign]):
    """The spec of every leaf, from the logical-axes tree and a tree of the
    same structure whose leaves have the global `.shape`."""
    axes = leaves(axes_tree, is_leaf=lambda x: isinstance(x, tuple))
    shapes = leaves(shape_tree)
    if len(axes) != len(shapes):
        raise ValueError(f"axes tree has {len(axes)} leaves, the tensors {len(shapes)}")
    return unflatten(shape_tree, [spec_for_axes(mesh, a, tuple(t.shape), rules)
                                  for a, t in zip(axes, shapes)])


def _chunk(mesh: Mesh, part: AxisAssign) -> Tuple[int, int]:
    """(this rank's index, number of chunks) along a dim assigned `part`:
    the index is row-major over the part's axes, the first outermost."""
    axes = (part,) if isinstance(part, str) else tuple(part)
    idx, n = 0, 1
    for a in axes:
        idx = idx * mesh.size(a) + mesh.index(a)
        n *= mesh.size(a)
    return idx, n


def shard_tensor(t: torch.Tensor, spec: Spec, mesh: Optional[Mesh]) -> torch.Tensor:
    """This rank's shard of the global tensor t (a copy, so the whole may be
    freed); a `Segmented` part's dim is cut segment by segment."""
    if mesh is None or not spec_axes(spec):
        return t
    out = t
    for dim, part in enumerate(spec):
        if part is None:
            continue
        idx, n = _chunk(mesh, part)
        if isinstance(part, Segmented):
            out = segment_chunk(out, dim, part, idx, n)
        else:
            c = t.shape[dim] // n
            out = out.narrow(dim, idx * c, c)
    return out.clone()


def unshard_tensor(t: torch.Tensor, spec: Spec, mesh: Optional[Mesh]) -> torch.Tensor:
    """The global tensor from this rank's shard: gathers over the spec's
    axes (the innermost axis of a tuple first); a `Segmented` part's
    segments are put back in order."""
    if mesh is None or not spec_axes(spec):
        return t
    for dim, part in enumerate(spec):
        if part is None:
            continue
        for a in reversed((part,) if isinstance(part, str) else tuple(part)):
            t = mesh.all_gather_tiled(t, a, dim)
            if isinstance(part, Segmented):
                t = segment_join(t.chunk(mesh.size(a), dim), dim, part.segments)
    return t


def shard_tree(tree, specs, mesh: Optional[Mesh]):
    return unflatten(tree, [shard_tensor(t, s, mesh) for t, s in
                            zip(leaves(tree), leaves(specs, is_leaf=_is_spec))])


def unshard_tree(tree, specs, mesh: Optional[Mesh]):
    return unflatten(tree, [unshard_tensor(t, s, mesh) for t, s in
                            zip(leaves(tree), leaves(specs, is_leaf=_is_spec))])


def _is_spec(x) -> bool:
    return isinstance(x, tuple)
