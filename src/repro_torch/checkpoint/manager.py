"""Checkpointing: atomic, async, keep-k, restore onto any device.

Port of src/repro/checkpoint/manager.py, with its on-disk format:

  <i>.npy    one file per leaf (np.save), leaves numbered in the order of
             `jax.tree.flatten` (dict entries in sorted-key order), so a
             checkpoint either side wrote restores on the other;
  tree.json  the structure, the leaf count and each leaf's shape and dtype;
  DONE       the commit marker, written last.

numpy has no bfloat16: a bf16 leaf is stored as its uint16 bits, and
tree.json names its dtype "bfloat16".

Guarantees, as the JAX manager's:
  * atomic commit: write into <step>.tmp, fsync every file, then the
    directory, rename, then fsync the parent: a crash mid-write never
    corrupts the latest checkpoint;
  * an overwrite renames the old checkpoint aside (<step>.old) and deletes
    it only after the new one has committed; a manager promotes an orphaned
    .old back when it starts (`_recover_interrupted_overwrites`);
  * async: `save(..., blocking=False)` copies the tree to the host at once
    (so the caller may update its tensors in place) and hands the copy to
    a writer thread; one save is outstanding at a time and its error
    surfaces on the next `wait()`;
  * keep-k garbage collection;
  * `restore(like, step, device=...)` places the leaves on `device` (the
    JAX manager takes shardings), which is how a run moves to another
    device.

On a mesh (`CheckpointManager(root, mesh=..., specs=...)`, the specs of
the state's leaves) the files stay in this format, the whole tensors: a
save gathers every leaf to the whole (a collective: every rank of the
mesh calls it), rank 0 copies it to the host and writes it as above, and
the other ranks wait at a barrier for that copy (for the write too when
the save blocks); a restore (collective too) waits for rank 0's write,
takes the step rank 0 names, reads the whole tensors and keeps the rank's
shard for the current mesh, whatever mesh wrote them.  `wait` is
collective on a mesh: every rank waits there for rank 0's write.  Each of
these waits on disk I/O is `mesh.barrier(io=True)`, whose timeout is the
world's: the mesh's other groups time out in minutes, and a write takes
as long as its bytes do.  So a checkpoint written at 2x2 loads at 1x2, 2x1 and
1x1 and one written at 1x1 loads at 2x2 (elastic rescale), and the JAX
manager reads either.
"""

from __future__ import annotations

import json
import os
import pathlib
import shutil
import threading
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike
from repro_torch.pytree import describe, leaves, tree_map, unflatten
from repro_torch.runtime.sharding import shard_tree, unshard_tree

DONE = "DONE"


def _fsync_path(p: pathlib.Path) -> None:
    """fsync a file or directory by path (directory fsync commits the
    entries: the file data AND the names must be durable before rename)."""
    fd = os.open(p, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _numpy(x) -> np.ndarray:
    """A leaf as numpy (a view of a CPU tensor): bf16 as its uint16 bits."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    return np.asarray(x)


def _dtype_name(x, arr: np.ndarray) -> str:
    if isinstance(x, torch.Tensor) and x.dtype == torch.bfloat16:
        return "bfloat16"
    return str(arr.dtype)


def _host_copy(x):
    """A host copy of a leaf that nothing else holds: the caller may change
    the original in place while a writer thread saves the copy."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True)
    return np.array(x)


def save_pytree(path: pathlib.Path, tree: Any) -> None:
    """Atomic synchronous save of a tree of tensors or arrays: write, fsync,
    rename.

    Every leaf file (and the metadata and DONE markers) is fsync'd, then the
    tmp directory, then the parent after the rename: os.replace alone only
    orders the METADATA, so a crash after an un-fsync'd rename could commit
    a directory with a DONE marker but garbage leaves."""
    path = pathlib.Path(path)
    tmp = path.with_suffix(".tmp")
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    flat = leaves(tree)
    meta = {"treedef": describe(tree), "n_leaves": len(flat), "leaves": []}
    for i, leaf in enumerate(flat):
        arr = _numpy(leaf)
        np.save(tmp / f"{i}.npy", arr)
        meta["leaves"].append({"shape": list(arr.shape), "dtype": _dtype_name(leaf, arr)})
    (tmp / "tree.json").write_text(json.dumps(meta))
    (tmp / DONE).write_text(str(time.time()))
    for f in sorted(tmp.iterdir()):
        _fsync_path(f)
    _fsync_path(tmp)
    if path.exists():
        # Never delete-then-rename: a crash between the two would lose BOTH
        # checkpoints.  Rename the old one aside (atomic), commit the new
        # one, then delete the old: at every instant one complete
        # checkpoint exists under a discoverable or recoverable name.
        old = path.with_name(path.name + ".old")
        if old.exists():
            shutil.rmtree(old)
        os.replace(path, old)
        os.replace(tmp, path)
        _fsync_path(path.parent)  # make the renames durable
        shutil.rmtree(old, ignore_errors=True)
    else:
        os.replace(tmp, path)
        _fsync_path(path.parent)  # make the rename itself durable


def load_pytree(path: pathlib.Path, like: Any, device: DeviceLike = None) -> Any:
    """Restore a tree saved by save_pytree (or by the JAX manager).

    `like` gives the structure (any tree of the same structure whose leaves
    have a `.shape`, e.g. a freshly initialised state or one on the meta
    device).  The leaves come back as tensors in their saved dtypes, on
    `device` (the CPU when None)."""
    path = pathlib.Path(path)
    if not (path / DONE).exists():
        raise FileNotFoundError(f"checkpoint {path} has no DONE marker")
    refs = leaves(like)
    metas = json.loads((path / "tree.json").read_text())
    if metas["n_leaves"] != len(refs):
        raise ValueError(
            f"checkpoint has {metas['n_leaves']} leaves, target tree has {len(refs)}"
        )
    dev = torch.device("cpu" if device is None else device)
    out = []
    for i, ref in enumerate(refs):
        arr = np.load(path / f"{i}.npy")
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(f"leaf {i}: checkpoint {arr.shape} vs target {tuple(ref.shape)}")
        if metas["leaves"][i]["dtype"] == "bfloat16":
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        out.append(t.to(dev))
    return unflatten(like, out)


class CheckpointManager:
    """Step-indexed checkpoints with keep-k GC and an async writer thread;
    on a mesh, rank 0 writes the whole tensors and every rank restores its
    shard."""

    def __init__(self, root, keep: int = 3, *, mesh=None, specs=None):
        self.root = pathlib.Path(root)
        self.mesh = mesh
        self.specs = specs
        self.writer = self.mesh is None or self.mesh.rank == 0
        if self.writer:
            self.root.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        if self.writer:
            self._recover_interrupted_overwrites()
        if self.mesh is not None:
            self.mesh.barrier(io=True)

    def _recover_interrupted_overwrites(self) -> None:
        """A crash inside save_pytree's overwrite window can leave a step
        only under step_*.old (renamed aside, new copy never committed).
        Promote such orphans back so the committed data stays discoverable;
        .old dirs whose base step exists are garbage from after the commit
        and are removed."""
        for p in self.root.glob("step_*.old"):
            base = p.with_name(p.name[: -len(".old")])
            if not p.is_dir():
                continue
            if base.exists():
                shutil.rmtree(p, ignore_errors=True)
            elif (p / DONE).exists():
                os.replace(p, base)

    # -- discovery ----------------------------------------------------------

    def steps(self):
        out = []
        for p in self.root.iterdir():
            # Exact step_<digits> only: leftover step_*.tmp / step_*.old dirs
            # from an interrupted save carry a DONE marker too but are not
            # committed checkpoints.
            if not (p.is_dir() and (p / DONE).exists()):
                continue
            prefix, _, suffix = p.name.partition("_")
            if prefix == "step" and suffix.isdigit():
                out.append(int(suffix))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def path(self, step: int) -> pathlib.Path:
        return self.root / f"step_{step:010d}"

    # -- save ---------------------------------------------------------------

    def save(self, step: int, tree: Any, blocking: bool = True) -> None:
        # One outstanding async save at a time; on a mesh every rank waits
        # here for rank 0's last write before the gathers below.
        self.wait()
        if self.mesh is not None:
            tree = unshard_tree(tree, self.specs, self.mesh)
            if not self.writer:
                del tree
                self.mesh.barrier(io=True)  # rank 0's host copy is taken (blocking: written)
                return
        # Device -> host copy here, synchronously: the caller may change its
        # tensors in place as soon as this returns.
        host_tree = tree_map(_host_copy, tree)
        del tree

        def work():
            try:
                save_pytree(self.path(step), host_tree)
                self._gc()
            except BaseException as e:  # surfaced on next wait()
                self._error = e

        if blocking:
            work()
        else:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()
        if self.mesh is not None:
            self.mesh.barrier(io=True)
        if blocking:
            self._raise_if_failed()

    def wait(self) -> None:
        """The outstanding async save is on disk (on a mesh, rank 0's: every
        rank calls this)."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.mesh is not None:
            self.mesh.barrier(io=True)
        self._raise_if_failed()

    def _raise_if_failed(self):
        if self._error is not None:
            e, self._error = self._error, None
            raise RuntimeError(f"async checkpoint write failed: {e!r}") from e

    # -- restore --------------------------------------------------------------

    def restore(self, like: Any, step: Optional[int] = None, device: DeviceLike = None):
        """(tree, step) of checkpoint `step` (the latest when None), or
        (None, None) when there is none; on a mesh `like` is the whole
        tree's and each rank gets its shard."""
        if self.mesh is None:
            step = self.latest_step() if step is None else step
            if step is None:
                return None, None
            return load_pytree(self.path(step), like, device), step
        self.wait()  # rank 0's writes are on disk
        if step is None:
            named = self.latest_step() if self.writer else None
            step = self.mesh.all_gather_object(named)[0]
        if step is None:
            return None, None
        tree = shard_tree(load_pytree(self.path(step), like, None), self.specs, self.mesh)
        tree = tree_map(lambda t: t.to(device) if device is not None else t, tree)
        self.mesh.barrier(io=True)  # every rank has read its shard
        return tree, step

    # -- gc ---------------------------------------------------------------------

    def _gc(self):
        steps = self.steps()
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(self.path(s), ignore_errors=True)

