"""Port: the checkpoint manager (repro_torch/checkpoint), one test per test
of tests/test_checkpoint.py (atomic commit, roundtrip, keep-k GC, async
writes, fsync ordering, interrupted overwrite), then the format across the
two packages: a checkpoint the JAX manager wrote restores into the port
with the same leaf numbering, and the reverse, bit for bit; bf16 leaves as
their uint16 bits; an async save's copy taken before the caller's next
in-place update; an async error surfacing on the next wait()."""

import os
import pathlib
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.checkpoint import CheckpointManager, load_pytree, save_pytree
from repro_torch.checkpoint import manager as mgr_mod
from repro_torch.pytree import leaves


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "a": torch.randn(8, 16, generator=g),
        "b": {"c": torch.arange(5, dtype=torch.int32), "d": torch.tensor(3.5)},
    }


def _equal(got, want):
    gl, wl = leaves(got), leaves(want)
    assert len(gl) == len(wl)
    for a, b in zip(gl, wl):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)


def test_roundtrip(tmp_path):
    t = _tree()
    save_pytree(tmp_path / "ck", t)
    _equal(load_pytree(tmp_path / "ck", t), t)


def test_incomplete_checkpoint_is_invisible(tmp_path):
    t = _tree()
    mgr = CheckpointManager(tmp_path, keep=3)
    mgr.save(10, t)
    broken = tmp_path / "step_0000000020"  # a crash mid-write: no DONE marker
    broken.mkdir()
    (broken / "tree.json").write_text("{}")
    assert mgr.latest_step() == 10
    with pytest.raises(FileNotFoundError):
        load_pytree(broken, t)


def test_keep_k_gc(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    for s in (1, 2, 3, 4, 5):
        mgr.save(s, _tree())
    assert mgr.steps() == [4, 5]


def test_async_save(tmp_path):
    t = _tree()
    mgr = CheckpointManager(tmp_path, keep=3)
    mgr.save(7, t, blocking=False)
    mgr.wait()
    restored, step = mgr.restore(t)
    assert step == 7
    _equal(restored, t)


def test_restore_latest_and_specific(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=5)
    for s in (10, 20):
        mgr.save(s, _tree(s))
    r20, s20 = mgr.restore(_tree())
    assert s20 == 20
    r10, s10 = mgr.restore(_tree(), step=10)
    assert s10 == 10
    _equal(r10, _tree(10))
    assert not torch.allclose(r10["a"], r20["a"])


def test_restore_empty_dir(tmp_path):
    out, step = CheckpointManager(tmp_path).restore(_tree())
    assert out is None and step is None


def test_shape_mismatch_raises(tmp_path):
    t = _tree()
    save_pytree(tmp_path / "ck", t)
    with pytest.raises(ValueError):
        load_pytree(tmp_path / "ck", {"a": torch.zeros(4, 4), "b": t["b"]})


def test_restore_onto_a_device(tmp_path):
    """The port's counterpart of test_restore_with_shardings: leaves land on
    the device asked for, from a `like` on the meta device (shapes only)."""
    t = _tree()
    save_pytree(tmp_path / "ck", t)
    like = {"a": torch.empty(8, 16, device="meta"),
            "b": {"c": torch.empty(5, device="meta"), "d": torch.empty((), device="meta")}}
    got = load_pytree(tmp_path / "ck", like, device="cpu")
    assert all(x.device == torch.device("cpu") for x in leaves(got))
    _equal(got, t)


def test_save_fsyncs_data_before_rename(tmp_path, monkeypatch):
    """write, FSYNC, rename: every leaf file, tree.json, DONE and the tmp
    directory before the first rename, and the parent after it."""
    synced = []
    real_fsync_path = mgr_mod._fsync_path

    def spy_fsync_path(p):
        synced.append(pathlib.Path(p))
        return real_fsync_path(p)

    real_replace = os.replace
    seen = {"n_synced_at_replace": None}

    def spy_replace(src, dst):
        if seen["n_synced_at_replace"] is None:
            seen["n_synced_at_replace"] = len(synced)
        return real_replace(src, dst)

    monkeypatch.setattr(mgr_mod, "_fsync_path", spy_fsync_path)
    monkeypatch.setattr(mgr_mod.os, "replace", spy_replace)
    t = _tree()
    save_pytree(tmp_path / "ck", t)
    n_leaves = len(leaves(t))
    assert seen["n_synced_at_replace"] >= n_leaves + 3
    names = [p.name for p in synced]
    for i in range(n_leaves):
        assert f"{i}.npy" in names
    assert "tree.json" in names and "DONE" in names
    assert synced[-1] == tmp_path
    _equal(load_pytree(tmp_path / "ck", t), t)


def test_overwrite_never_deletes_before_commit(tmp_path, monkeypatch):
    t1, t2 = _tree(1), _tree(2)
    save_pytree(tmp_path / "ck", t1)
    removed_before_commit = []
    real_rmtree = shutil.rmtree

    def spy_rmtree(p, **kw):
        if str(p) == str(tmp_path / "ck"):
            removed_before_commit.append(str(p))
        return real_rmtree(p, **kw)

    monkeypatch.setattr(mgr_mod.shutil, "rmtree", spy_rmtree)
    save_pytree(tmp_path / "ck", t2)
    assert removed_before_commit == []
    _equal(load_pytree(tmp_path / "ck", t2), t2)
    assert not (tmp_path / "ck.old").exists()


def test_leftover_tmp_and_old_dirs_are_invisible(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=3)
    mgr.save(10, _tree())
    for leftover in ("step_0000000020.tmp", "step_0000000015.old"):
        d = tmp_path / leftover
        d.mkdir()
        (d / "DONE").write_text("1.0")
    assert mgr.steps() == [10]
    assert mgr.latest_step() == 10


def test_interrupted_overwrite_recovers_from_old(tmp_path):
    t = _tree()
    mgr = CheckpointManager(tmp_path, keep=3)
    mgr.save(10, t)
    p10 = mgr.path(10)
    os.replace(p10, p10.with_name(p10.name + ".old"))  # died inside the overwrite
    assert CheckpointManager(tmp_path, keep=3).steps() == [10]
    restored, step = CheckpointManager(tmp_path, keep=3).restore(t)
    assert step == 10
    _equal(restored, t)


# -- across the two packages ------------------------------------------------


def _state_np(seed=0):
    """A train-state-shaped tree, keys deliberately out of sorted order."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return {"step": np.asarray(7, np.int32),
            "params": {"layers": {"wq": f(2, 4, 3), "norm": {}}, "embed": {"table": f(5, 4)}},
            "opt": {"v": {"layers": {"wq": f(2, 4, 3), "norm": {}}, "embed": {"table": f(5, 4)}},
                    "m": {"layers": {"wq": f(2, 4, 3), "norm": {}}, "embed": {"table": f(5, 4)}}}}


def test_a_jax_checkpoint_restores_into_the_port(tmp_path):
    from repro.checkpoint import CheckpointManager as JaxManager

    tree = _state_np()
    JaxManager(tmp_path).save(3, jax.tree.map(jnp.asarray, tree))
    like = jax.tree.map(lambda a: torch.empty(a.shape, device="meta"), tree)
    got, step = CheckpointManager(tmp_path).restore(like)
    assert step == 3
    for g, w in zip(leaves(got), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(g.numpy(), w)
    assert got["step"].dtype == torch.int32 and int(got["step"]) == 7
    np.testing.assert_array_equal(got["opt"]["m"]["embed"]["table"].numpy(),
                                  tree["opt"]["m"]["embed"]["table"])


def test_a_port_checkpoint_restores_into_jax(tmp_path):
    from repro.checkpoint import CheckpointManager as JaxManager

    tree = _state_np(1)
    CheckpointManager(tmp_path).save(4, jax.tree.map(torch.from_numpy, tree))
    got, step = JaxManager(tmp_path).restore(tree)
    assert step == 4
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(np.asarray(g), w)


def test_bf16_leaves_roundtrip_as_their_bits(tmp_path):
    t = {"w": torch.randn(3, 5).to(torch.bfloat16), "s": torch.tensor(2, dtype=torch.int32)}
    save_pytree(tmp_path / "ck", t)
    import json

    meta = json.loads((tmp_path / "ck" / "tree.json").read_text())
    assert [m["dtype"] for m in meta["leaves"]] == ["int32", "bfloat16"]  # s, w
    assert np.load(tmp_path / "ck" / "1.npy").dtype == np.uint16
    _equal(load_pytree(tmp_path / "ck", t), t)


def test_async_copy_is_taken_before_the_caller_moves_on(tmp_path):
    """The caller updates its tensors in place right after save() returns
    (the runner's optimizer does); the checkpoint holds the values at save."""
    t = _tree()
    want = {"a": t["a"].clone(), "b": {"c": t["b"]["c"].clone(), "d": t["b"]["d"].clone()}}
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, t, blocking=False)
    t["a"].add_(1.0)
    t["b"]["c"].add_(1)
    mgr.wait()
    _equal(mgr.restore(want)[0], want)


def test_async_error_surfaces_on_next_wait(tmp_path, monkeypatch):
    def broken(path, tree):
        raise OSError("disk full")

    mgr = CheckpointManager(tmp_path)
    monkeypatch.setattr(mgr_mod, "save_pytree", broken)
    mgr.save(1, _tree(), blocking=False)
    with pytest.raises(RuntimeError, match="disk full"):
        mgr.wait()
    mgr.wait()  # raised once
