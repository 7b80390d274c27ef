"""A device mesh over the ranks of `torch.distributed`, its collectives, and
the launcher that spawns its ranks.

Port of the mesh part of src/repro/runtime/dist.py (the axis names, the
mesh factories, the tiled collectives of dist.py:881-900), of
runtime/compat.make_mesh / axis_sizes, and of launch/mesh.py.  The JAX
package builds a `jax.sharding.Mesh` over devices and lets GSPMD place the
collectives; PyTorch has no GSPMD, so here a mesh is a grid of processes
(ranks), one process group per axis, and the model code calls the
collectives itself (Megatron-style tensor parallelism).  Every collective
of a sharded run goes through this module, as every one of the JAX
engine's goes through runtime/dist.py.

A `Mesh` names its axes (`pod`, `data`, `model`, outermost first), their
sizes, this rank's coordinates and one process group per axis; mesh rank r
sits at the row-major coordinates of r.  It may cover the first ranks of a
larger world (the others hold None), so one spawned world can run meshes
of several shapes one after the other (a rescale from 2x2 to 1x2).

Collectives over an axis (`psum`, `pmax`, `all_gather_tiled`,
`psum_scatter_tiled`, `all_to_all_tiled`) have dist.py's tiled semantics,
and `ppermute` `lax.ppermute`'s over static (src, dst) pairs (the gossip
rounds of runtime/comm.py's mesh wire); `gather_first` concatenates onto
the axis's first rank only; on an axis of size 1 each returns its input
and calls no backend.  A psum
of a float tensor narrower than fp32 sums in fp32 and rounds once.
`broadcast`, `barrier` and `all_gather_object` span the whole mesh.
`traffic` counts, per axis, the collectives this rank ran and the bytes it
put on the wire (runtime/steps keeps a step's share in `step_traffic`).  The
autograd Functions below give the differentiable versions: all_gather's
transpose is psum_scatter, all_to_all's is all_to_all, and Megatron's f
(identity forward, psum backward) and g (psum forward, identity backward);
`split` (slice forward, all_gather backward) and `gather` (all_gather
forward, slice backward) move a tensor that is replicated over an axis to
its shards and back.

Transports:
  "gloo"         CPU tensors through gloo (the tests, `--device cpu`);
  "nccl"         one rank per card, rank r on cuda:r;
  "gloo_staged"  several ranks on one card: a CUDA tensor is copied to
                 pinned host memory, goes through the gloo op and comes back
                 (NCCL refuses two ranks on one device).  The compute stays
                 on the card; only the wire is host memory.
`launch` picks "nccl" only when there are at least as many cards as ranks,
prints its choice and never tries another transport when one fails.  A
world of one rank runs in the calling process (nothing to spawn).
Every process group of a mesh has a timeout of GROUP_TIMEOUT, so a rank
that raised turns into a failure of the run, not a hang (and `launch`
stops the other ranks as soon as one fails).  The one exception is the
wait for checkpoint I/O (`barrier(io=True)`): rank 0 alone writes the
whole tensors, for as long as their bytes take, so the other ranks wait
for it on a group with the world's timeout; so is a follower's wait for
the dictionary service's next request (`broadcast(io=True)`), which lasts
as long as the stream is idle.
"""

from __future__ import annotations

import dataclasses
import datetime
import math
import os
import pickle
import socket
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

# Canonical axis roles, as the JAX package's (dist.py:160-165).
MODEL_AXIS = "model"
DATA_AXIS = "data"
POD_AXIS = "pod"
AXES = (POD_AXIS, DATA_AXIS, MODEL_AXIS)
TRANSPORTS = ("gloo", "nccl", "gloo_staged")
GROUP_TIMEOUT = datetime.timedelta(seconds=120)
# The default group only joins the world between meshes (a rank outside a
# mesh waits there while the mesh trains), so it waits longer.
WORLD_TIMEOUT = datetime.timedelta(minutes=30)


def parse_mesh(spec) -> Tuple[int, ...]:
    """"DxM" (or "PxDxM", or an int tuple) -> the shape tuple."""
    if isinstance(spec, str):
        try:
            shape = tuple(int(x) for x in spec.lower().split("x"))
        except ValueError:
            raise ValueError(f"mesh {spec!r}: expected DATAxMODEL, e.g. 2x2") from None
    else:
        shape = tuple(int(x) for x in spec)
    if not shape or any(n < 1 for n in shape):
        raise ValueError(f"mesh {spec!r}: every axis needs at least one rank")
    return shape


def default_axes(shape: Sequence[int]) -> Tuple[str, ...]:
    """The axis names of a shape: (data, model), or (pod, data, model)."""
    if len(shape) not in (2, 3):
        raise ValueError(f"mesh shape {tuple(shape)}: expected (data, model) or "
                         f"(pod, data, model)")
    return AXES[-len(shape):]


@dataclasses.dataclass
class Mesh:
    """A grid of ranks: axis names and sizes, this rank's place, its groups."""

    axis_names: Tuple[str, ...]
    axis_shape: Tuple[int, ...]
    rank: int  # this process's rank in the mesh (its world rank)
    transport: str
    device: torch.device
    groups: Dict[str, Any]  # axis -> process group (none where the size is 1)
    group: Any = None  # the whole mesh
    io_group: Any = None  # the whole mesh, with WORLD_TIMEOUT: waits on checkpoint I/O
    members: Dict[str, List[int]] = dataclasses.field(default_factory=dict)  # world ranks
    # per axis: [calls, bytes this rank put on the wire]
    traffic: Dict[str, List[int]] = dataclasses.field(default_factory=dict)
    step_traffic: Dict[str, List[int]] = dataclasses.field(default_factory=dict)

    def _count(self, axis: str, t: torch.Tensor) -> None:
        c = self.traffic.setdefault(axis, [0, 0])
        c[0] += 1
        c[1] += t.numel() * t.element_size()

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_shape))

    @property
    def world(self) -> int:
        return math.prod(self.axis_shape)

    @property
    def coords(self) -> Dict[str, int]:
        out, r = {}, self.rank
        for name, n in reversed(list(zip(self.axis_names, self.axis_shape))):
            out[name] = r % n
            r //= n
        return dict(reversed(list(out.items())))

    def size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def index(self, axis: str) -> int:
        return self.coords.get(axis, 0)

    def describe(self) -> str:
        return "x".join(str(n) for n in self.axis_shape)

    # -- the wire --------------------------------------------------------------

    def _to_wire(self, x: torch.Tensor, copy: bool = False) -> torch.Tensor:
        """x as the backend takes it: contiguous, in pinned host memory for
        gloo_staged; with copy, a buffer of its own that an in-place
        collective may overwrite."""
        x = x.detach()  # the raw collectives carry no graph (the Functions below do)
        if self.transport == "gloo_staged" and x.is_cuda:
            host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            host.copy_(x)
            return host
        if self.transport == "gloo" and x.is_cuda:
            raise RuntimeError("the gloo transport carries CPU tensors; use gloo_staged "
                               "for several ranks on one card")
        return x.clone(memory_format=torch.contiguous_format) if copy else x.contiguous()

    def _from_wire(self, y: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        return y.to(like.device, non_blocking=False) if y.device != like.device else y

    # -- collectives over one axis ------------------------------------------------

    def psum(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """Sum over `axis`; a float narrower than fp32 sums in fp32 and rounds
        once (over two ranks its own sum is that: two bf16 or fp16 values
        add exactly in fp32, or the smaller is below half an ulp of the
        larger)."""
        n = self.size(axis)
        if n == 1:
            return x
        narrow = x.is_floating_point() and x.element_size() < 4
        wide = x.float() if narrow and n > 2 else x
        w = self._to_wire(wide, copy=wide is x)
        self._count(axis, w)
        dist.all_reduce(w, op=dist.ReduceOp.SUM, group=self.groups[axis])
        return self._from_wire(w, x).to(x.dtype)

    def pmax(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        if self.size(axis) == 1:
            return x
        w = self._to_wire(x, copy=True)
        self._count(axis, w)
        dist.all_reduce(w, op=dist.ReduceOp.MAX, group=self.groups[axis])
        return self._from_wire(w, x)

    def all_gather_tiled(self, x: torch.Tensor, axis: str, dim: int = 0) -> torch.Tensor:
        """Concatenate every rank's x along `dim`, in the axis's rank order."""
        n = self.size(axis)
        if n == 1:
            return x
        lead = self._to_wire(x.movedim(dim, 0), copy=True)
        self._count(axis, lead)
        out = self._wire_buffer((n * lead.shape[0], *lead.shape[1:]), lead)
        if self.transport == "nccl":
            _all_gather_single(out, lead, group=self.groups[axis])
        else:
            chunks = out.chunk(n)
            chunks[self.index(axis)].copy_(lead)
            self._exchange(axis, [lead] * n, chunks)
        return self._from_wire(out, x).movedim(0, dim).contiguous()

    def psum_scatter_tiled(self, x: torch.Tensor, axis: str, dim: int = 0) -> torch.Tensor:
        """The sum over `axis`, of which this rank keeps its chunk along
        `dim` (the transpose of all_gather_tiled)."""
        n = self.size(axis)
        if n == 1:
            return x
        c = x.shape[dim] // n
        return self.psum(x, axis).narrow(dim, self.index(axis) * c, c).contiguous()

    def all_to_all_tiled(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """Chunk i of the leading dim goes to rank i of `axis`; chunk j of
        the result came from rank j."""
        if self.size(axis) == 1:
            return x
        w = self._to_wire(x)
        self._count(axis, w)
        out = self._wire_buffer(w.shape, w)
        if self.transport == "nccl":
            dist.all_to_all_single(out, w, group=self.groups[axis])
        else:
            n, me = self.size(axis), self.index(axis)
            sends, recvs = w.chunk(n), out.chunk(n)
            recvs[me].copy_(sends[me])
            self._exchange(axis, sends, recvs)
        return self._from_wire(out, x)

    def _wire_buffer(self, shape, like: torch.Tensor) -> torch.Tensor:
        """An output buffer beside a wire tensor (pinned when staged)."""
        return torch.empty(shape, dtype=like.dtype, device=like.device,
                           pin_memory=self.transport == "gloo_staged")

    def ppermute(self, x: torch.Tensor, axis: str, pairs) -> torch.Tensor:
        """`lax.ppermute` over `axis`: for each static (src, dst) of `pairs`
        (indices along the axis, no src and no dst twice) rank dst receives
        rank src's x; a rank that is no pair's destination receives zeros.
        Only a message to another rank crosses the wire (and is counted in
        `traffic`); a self-pair keeps x."""
        n, me = self.size(axis), self.index(axis)
        pairs = [(int(s), int(d)) for s, d in pairs]
        srcs, dsts = [s for s, _ in pairs], [d for _, d in pairs]
        if len(set(srcs)) < len(srcs) or len(set(dsts)) < len(dsts) or \
                any(not 0 <= v < n for v in srcs + dsts):
            raise ValueError(f"ppermute over {axis!r} ({n} ranks): pairs {pairs} must name "
                             f"each source and each destination at most once")
        dst = next((d for s, d in pairs if s == me and d != me), None)
        src = next((s for s, d in pairs if d == me), None)
        if dst is None and src in (None, me):  # nothing crosses (always on a size-1 axis)
            return x if src == me else torch.zeros_like(x)
        w = self._to_wire(x)
        ops = []
        if dst is not None:
            self._count(axis, w)
            ops.append((dist.isend, w, dst))
        if src not in (None, me):
            out = self._wire_buffer(w.shape, w)
            ops.append((dist.irecv, out, src))
        self._p2p(axis, ops)
        if src is None:
            return torch.zeros_like(x)
        return x if src == me else self._from_wire(out, x)

    def gather_first(self, x: torch.Tensor, axis: str) -> Optional[torch.Tensor]:
        """Every rank's x along `axis`, concatenated on dim 0 in the axis's
        order, on the axis's first rank (None on the others): each other
        rank sends its x there once (a gather, where all_gather_tiled
        would send it to every rank)."""
        n, me = self.size(axis), self.index(axis)
        if n == 1:
            return x
        w = self._to_wire(x)
        if me:
            self._count(axis, w)
            self._p2p(axis, [(dist.isend, w, 0)])
            return None
        out = self._wire_buffer((n * w.shape[0], *w.shape[1:]), w)
        chunks = out.chunk(n)
        chunks[0].copy_(w)
        self._p2p(axis, [(dist.irecv, chunks[j], j) for j in range(1, n)])
        return self._from_wire(out, x)

    def _p2p(self, axis: str, ops) -> None:
        """Post every (isend or irecv, tensor, index along `axis`) at once
        and wait for all (nccl: one batch_isend_irecv)."""
        group, members = self.groups[axis], self.members[axis]
        if self.transport == "nccl":
            reqs = dist.batch_isend_irecv([dist.P2POp(op, t, members[j], group=group)
                                           for op, t, j in ops])
        else:
            reqs = [op(t, members[j], group=group) for op, t, j in ops]
        for r in reqs:
            r.wait()

    def _exchange(self, axis: str, sends, recvs) -> None:
        """gloo: sends[j] to the j-th rank of `axis` and its message into
        recvs[j], for every j but this rank's, all posted at once (gloo's
        own all_gather and all_to_all move the same bytes slower over
        loopback TCP)."""
        group, me = self.groups[axis], self.index(axis)
        reqs = []
        for j, peer in enumerate(self.members[axis]):
            if j != me:
                reqs.append(dist.isend(sends[j].contiguous(), peer, group=group))
                reqs.append(dist.irecv(recvs[j], peer, group=group))
        for r in reqs:
            r.wait()

    # -- over the whole mesh --------------------------------------------------------

    def broadcast(self, x: torch.Tensor, src: int = 0, io: bool = False) -> torch.Tensor:
        """x of mesh rank `src` on every rank; with io, on the group whose
        timeout is the world's (a wait that may last, as barrier's)."""
        w = self._to_wire(x, copy=True)
        dist.broadcast(w, src=src, group=self.io_group if io else self.group)
        return self._from_wire(w, x)

    def barrier(self, io: bool = False) -> None:
        """Every mesh rank reaches this point; with io, on the group whose
        timeout is the world's (a wait on a checkpoint's disk I/O)."""
        dist.barrier(group=self.io_group if io else self.group, **(
            {"device_ids": [self.device.index]} if self.transport == "nccl" else {}))

    def all_gather_object(self, obj) -> List[Any]:
        out: List[Any] = [None] * self.world
        dist.all_gather_object(out, obj, group=self.group)
        return out


def _all_gather_single(out, x, group) -> None:
    """all_gather into one tensor, under either of torch's names for it."""
    fn = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    fn(out, x, group=group)


def axis_sizes(mesh) -> Dict[str, int]:
    """Axis name -> size, for a Mesh, a {name: size} dict or None (1x1)."""
    if mesh is None:
        return {}
    if isinstance(mesh, Mesh):
        return mesh.shape
    return {str(k): int(v) for k, v in dict(mesh).items()}


# This process's transport and device, as `launch` set them.
_RANK: Dict[str, Any] = {}


def make_mesh(shape: Sequence[int], axes: Optional[Sequence[str]] = None, *,
              transport: Optional[str] = None, device=None) -> Optional[Mesh]:
    """The mesh of `shape` over world ranks 0 .. prod(shape) - 1.  Every
    rank of the world calls it (process groups are made collectively);
    ranks past the mesh get None.  The transport and device default to
    what `launch` gave this rank."""
    transport = transport or _RANK["transport"]
    device = device if device is not None else _RANK["device"]
    shape = tuple(int(n) for n in shape)
    axes = tuple(axes) if axes is not None else default_axes(shape)
    if len(axes) != len(shape):
        raise ValueError(f"mesh shape {shape} vs axis names {axes}")
    n = math.prod(shape)
    world, rank = dist.get_world_size(), dist.get_rank()
    if n > world:
        raise ValueError(f"mesh {shape} needs {n} ranks, the world has {world}")
    ranks = list(range(n))
    strides = [math.prod(shape[i + 1:]) for i in range(len(shape))]
    groups: Dict[str, Any] = {}
    lines: Dict[str, List[int]] = {}
    for ai, (name, size) in enumerate(zip(axes, shape)):
        if size == 1:
            continue
        # one group per line along this axis (its coordinate 0 first), made
        # in the same order on every rank
        for base in ranks:
            if (base // strides[ai]) % size:
                continue
            members = [base + j * strides[ai] for j in range(size)]
            g = dist.new_group(members, timeout=GROUP_TIMEOUT)
            if rank in members:
                groups[name], lines[name] = g, members
    group = dist.new_group(ranks, timeout=GROUP_TIMEOUT)
    io_group = dist.new_group(ranks, timeout=WORLD_TIMEOUT)
    if rank >= n:
        return None
    return Mesh(axes, shape, rank, transport, torch.device(device), groups, group, io_group,
                lines)


# ---------------------------------------------------------------------------
# Differentiable collectives
# ---------------------------------------------------------------------------


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return mesh.all_gather_tiled(x, axis, dim)

    @staticmethod
    def backward(ctx, dy):
        return ctx.mesh.psum_scatter_tiled(dy, ctx.axis, ctx.dim), None, None, None


class _PsumScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return mesh.psum_scatter_tiled(x, axis, dim)

    @staticmethod
    def backward(ctx, dy):
        return ctx.mesh.all_gather_tiled(dy, ctx.axis, ctx.dim), None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return mesh.all_to_all_tiled(x, axis)

    @staticmethod
    def backward(ctx, dy):
        return ctx.mesh.all_to_all_tiled(dy, ctx.axis), None, None


class _CopyIn(torch.autograd.Function):
    """Megatron's f: identity forward, psum backward."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        return ctx.mesh.psum(dy, ctx.axis), None, None


class _ReduceOut(torch.autograd.Function):
    """Megatron's g: psum forward, identity backward."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        return mesh.psum(x, axis)

    @staticmethod
    def backward(ctx, dy):
        return dy, None, None


class _Split(torch.autograd.Function):
    """A tensor replicated over `axis` -> this rank's chunk along `dim`;
    the backward gathers the chunks' gradients back to the whole."""

    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        c = x.shape[dim] // mesh.size(axis)
        return x.narrow(dim, mesh.index(axis) * c, c)

    @staticmethod
    def backward(ctx, dy):
        return ctx.mesh.all_gather_tiled(dy.contiguous(), ctx.axis, ctx.dim), None, None, None


class _Gather(torch.autograd.Function):
    """Chunks along `dim` -> the whole, replicated over `axis`; the backward
    keeps this rank's chunk of the (replicated) gradient."""

    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim, ctx.c = mesh, axis, dim, x.shape[dim]
        return mesh.all_gather_tiled(x, axis, dim)

    @staticmethod
    def backward(ctx, dy):
        return dy.narrow(ctx.dim, ctx.mesh.index(ctx.axis) * ctx.c, ctx.c), None, None, None


def pmean_value(x, mesh: Mesh, axes) -> torch.Tensor:
    """The mean of x over `axes` as the value, with the gradient of this
    rank's own term (for a data-parallel loss term that spans the data
    ranks, whose per-rank gradients the step then averages)."""
    for ax in axes:
        x = x + (mesh.psum(x.detach(), ax) / mesh.size(ax) - x.detach())
    return x


def all_gather(x, mesh: Mesh, axis: str, dim: int = 0):
    return x if mesh.size(axis) == 1 else _AllGather.apply(x, mesh, axis, dim)


def psum_scatter(x, mesh: Mesh, axis: str, dim: int = 0):
    return x if mesh.size(axis) == 1 else _PsumScatter.apply(x, mesh, axis, dim)


def all_to_all(x, mesh: Mesh, axis: str):
    return x if mesh.size(axis) == 1 else _AllToAll.apply(x, mesh, axis)


def f(x, mesh: Mesh, axis: str = MODEL_AXIS):
    """Enter a tensor-parallel region: identity forward, psum backward."""
    return x if mesh.size(axis) == 1 else _CopyIn.apply(x, mesh, axis)


def g(x, mesh: Mesh, axis: str = MODEL_AXIS):
    """Leave a tensor-parallel region: psum forward, identity backward."""
    return x if mesh.size(axis) == 1 else _ReduceOut.apply(x, mesh, axis)


def split(x, mesh: Mesh, axis: str, dim: int):
    return x if mesh.size(axis) == 1 else _Split.apply(x, mesh, axis, dim)


def gather(x, mesh: Mesh, axis: str, dim: int):
    return x if mesh.size(axis) == 1 else _Gather.apply(x, mesh, axis, dim)


# ---------------------------------------------------------------------------
# Launch
# ---------------------------------------------------------------------------


def choose_transport(transport: str, device, world: int) -> str:
    """"auto": gloo on the CPU; nccl when there are at least as many cards
    as ranks; gloo_staged for several ranks on fewer cards."""
    dev = torch.device("cuda" if device is None else device)
    if transport != "auto":
        if transport not in TRANSPORTS:
            raise ValueError(f"transport {transport!r}: one of auto, {', '.join(TRANSPORTS)}")
        if dev.type == "cpu" and transport != "gloo":
            raise ValueError(f"transport {transport!r} carries CUDA tensors; the CPU runs gloo")
        if dev.type == "cuda" and transport == "gloo":
            raise ValueError("transport 'gloo' carries CPU tensors; on the card use "
                             "gloo_staged or nccl")
        if transport == "nccl" and torch.cuda.device_count() < world:
            raise ValueError(f"transport nccl needs one card a rank: {world} ranks, "
                             f"{torch.cuda.device_count()} cards")
        return transport
    if dev.type == "cpu":
        return "gloo"
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' (--device cpu) "
                           "to run the mesh on the CPU")
    return "nccl" if torch.cuda.device_count() >= world else "gloo_staged"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_device(transport: str, device, rank: int) -> torch.device:
    if transport == "gloo":
        return torch.device("cpu")
    if transport == "nccl":
        return torch.device("cuda", rank)
    return torch.device("cuda", torch.device(device).index or 0)


def startup_seconds() -> float:
    """Seconds from `launch` to this rank's function (spawn, imports, the
    process group and the mesh's groups)."""
    return _RANK["startup_s"]


def _warm_imports() -> None:
    """What a rank's first `torch.utils.checkpoint` call would import
    (torch's compiler stack, seconds in each new process)."""
    import torch._dynamo  # noqa: F401


def _run_rank(rank, fn, shape, axes, world, port, transport, device, args, threads,
              t_launch):
    """This process as rank `rank` of the world: join it, build the mesh,
    run fn(mesh, *args) and leave the world; fn's result."""
    import threading

    warm = threading.Thread(target=_warm_imports, daemon=True)  # beside the rendezvous
    warm.start()
    if threads:
        torch.set_num_threads(threads)
    dev = _rank_device(transport, device, rank)
    _RANK.update(transport=transport, device=dev)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = "nccl" if transport == "nccl" else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world, timeout=WORLD_TIMEOUT,
                            **({"device_id": dev} if transport == "nccl" else {}))
    try:
        mesh = make_mesh(shape, axes, transport=transport, device=dev)
        warm.join()
        _RANK["startup_s"] = time.time() - t_launch
        return fn(mesh, *args)
    finally:
        dist.destroy_process_group()


def _entry(rank, fn, shape, axes, world, port, transport, device, args, out_path, threads,
           t_launch):
    result = _run_rank(rank, fn, shape, axes, world, port, transport, device, args, threads,
                       t_launch)
    if rank == 0:
        with open(out_path, "wb") as fh:
            pickle.dump(result, fh)


def launch(fn: Callable, shape: Sequence[int], *, axes: Optional[Sequence[str]] = None,
           transport: str = "auto", device="cuda", args: tuple = (),
           world: Optional[int] = None, threads: Optional[int] = None, quiet: bool = False,
           timeout: Optional[float] = None, kernels: Sequence[str] = ("flash_attention",)):
    """Spawn `world` ranks (default prod(shape)), each running
    fn(mesh, *args) with the mesh of `shape` over its first ranks (None on
    the others); returns rank 0's result.  fn and args must pickle (a
    module-level function).  A rank that raises fails the run: the other
    ranks are stopped and the error is raised here; so does a run past
    `timeout` seconds (TimeoutError).  On the CPU each rank runs `threads`
    threads (default: the cores over the ranks).  A world of one rank is
    this process: fn runs here (no timeout), and the process leaves the
    world, its torch threads as they were, when fn returns or raises.  On
    the card the `kernels` the ranks launch are built here first (one nvcc
    each, in parallel), so that no rank runs nvcc."""
    import torch.multiprocessing as mp

    shape = parse_mesh(shape)
    world = world or math.prod(shape)
    transport = choose_transport(transport, device, world)
    if not quiet:
        print(f"[mesh] {'x'.join(map(str, shape))} over {world} ranks, transport {transport}",
              flush=True)
    if transport != "gloo" and kernels:
        from repro_torch.kernels import build

        build.build(list(kernels))  # once here, not once a rank
    if threads is None and torch.device(device).type == "cpu":
        threads = max(1, (os.cpu_count() or 1) // world)
    if world == 1:
        kept = torch.get_num_threads()
        try:
            return _run_rank(0, fn, shape, axes, 1, _free_port(), transport, device, args,
                             threads, time.time())
        finally:
            torch.set_num_threads(kept)
            _RANK.clear()
    with tempfile.TemporaryDirectory(prefix="mesh_") as tmp:
        out_path = os.path.join(tmp, "rank0.pkl")
        ctx = mp.start_processes(
            _entry, args=(fn, shape, axes, world, _free_port(), transport, device, args,
                          out_path, threads, time.time()),
            nprocs=world, join=False, start_method="spawn")
        t0 = time.monotonic()
        while not ctx.join(timeout=1.0):
            if timeout is not None and time.monotonic() - t0 > timeout:
                for p in ctx.processes:
                    if p.is_alive():
                        p.kill()
                for p in ctx.processes:
                    p.join()
                raise TimeoutError(f"mesh {shape}: the ranks ran past {timeout} s")
        with open(out_path, "rb") as fh:
            return pickle.load(fh)
