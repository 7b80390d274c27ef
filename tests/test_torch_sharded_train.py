"""Sharded training over a (data, model) mesh against the port's 1x1 step and
JAX's single-device loss and gradient.

One world of four gloo ranks on the CPU (module-scoped) trains the SMOKE
configs of olmo_1b (dense) and granite_moe_1b_a400m (MoE, through
models/moe_a2a) at 1x2, 2x1 and 2x2, granite also at 1x4 (its two kv heads
stay whole on a model axis of 4: the kv-head fallback) and kimi-k2's
SMOKE at 1x2 (a leading dense layer, a shared expert column- and
row-parallel), each from the same numpy params and batches as here:

  * the loss and every gradient of one batch (the gradients averaged over
    `data`, gathered whole) against jax.value_and_grad(M.loss_fn) and the
    port's 1x1 loss_fn, at LOSS_RTOL / GRAD_RTOL;
  * three SGD steps: losses and params against the 1x1 steps;
  * three AdamW steps at 2x2: the losses against the 1x1 steps;
  * the runner at 2x2: a checkpoint every 2, a fault at 3, the replayed
    loss equal to the first pass's bit for bit; the 2x2 checkpoint
    restored at 1x2, 2x1, 1x1 and 2x2 (each rank's shard its cut of the
    file's whole tensors) and a 1x1 checkpoint restored at 2x2; JAX's
    CheckpointManager reads the 2x2 checkpoint;
  * checkpoint writes slower than the mesh groups' timeout: the other
    ranks wait them out (the waits on disk I/O have the world's timeout).

The MoE configs run at capacity_factor 4.0, where no token is dropped: the
all-to-all path and the single-device capacity dispatch bucket tokens
under different capacities (JAX's semantics), so only then are the two
the same function (tests/test_torch_moe_a2a.py holds the path with drops
against JAX's own apply_moe_a2a).  kimi runs its native wire here (the
int8 wire is held in test_torch_moe_a2a.py).  Then the CLI: its
refusals (and launch/serve's on a mesh), and a rank that raises failing
the run.
"""

import dataclasses
import functools
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_workers as W
from test_torch_common import REPO, SRC

WORLD_TIMEOUT = 420  # seconds the spawned world may run (launch raises past it)
LOSS_RTOL, GRAD_RTOL = 1e-5, 1e-5
B, S, N_STEPS = 4, 16, 3
SGD_LR, ADAMW_LR = 0.5, 1e-3
# The slow-write case: the mesh's groups time out after SLOW_TIMEOUT_S,
# rank 0 takes SLOW_WRITE_S more than that over each write.
SLOW_TIMEOUT_S, SLOW_WRITE_S = 2, 5
CASES = {
    "olmo_1b": ((1, 2), (2, 1), (2, 2)),
    "granite_moe_1b_a400m": ((1, 2), (2, 1), (2, 2), (1, 4)),
    "kimi_k2_1t_a32b": ((1, 2),),
}


def _overrides(arch):
    if arch == "olmo_1b":
        return {}
    return {"capacity_factor": 4.0, "moe_wire_dtype": "native"}


def _cfg(arch):
    from repro_torch.configs import get_smoke_config

    return dataclasses.replace(get_smoke_config(arch), **_overrides(arch))


def _jax_cfg(arch):
    from repro.configs import get_smoke_config

    return dataclasses.replace(get_smoke_config(arch), **_overrides(arch))


@functools.lru_cache(maxsize=None)
def _params(arch):
    from repro.models import model as JM
    from repro.models.layers import split_tree

    vals, _ = split_tree(JM.init(_jax_cfg(arch), jax.random.PRNGKey(0)))
    return jax.tree.map(np.asarray, vals)


def _batches(arch):
    rng = np.random.default_rng(7)
    return [{"tokens": rng.integers(0, _cfg(arch).vocab, (B, S)).astype(np.int32)}
            for _ in range(N_STEPS)]


def _port(arch):
    from repro_torch.convert import lm_params_from_numpy

    return lm_params_from_numpy(_cfg(arch), _params(arch), device="cpu")


@functools.lru_cache(maxsize=None)
def _one_device(arch):
    """The port's 1x1 loss and gradients of batch 0, and its SGD and AdamW
    runs of N_STEPS steps."""
    from repro_torch.models import model
    from repro_torch.optim import adamw, sgd
    from repro_torch.pytree import leaves
    from repro_torch.runtime import steps

    cfg = _cfg(arch)
    params = _port(arch)
    flat = leaves(params)
    for p in flat:
        p.requires_grad_(True)
    loss, _ = model.loss_fn(cfg, params, {"tokens": torch.from_numpy(_batches(arch)[0]["tokens"])})
    grads = [g.numpy() for g in torch.autograd.grad(loss, flat)]
    out = {"loss": float(loss.detach()), "grads": grads}
    for name, opt in (("sgd", sgd(SGD_LR)), ("adamw", adamw(ADAMW_LR))):
        state = steps.init_train_state(cfg, opt, 0, "cpu")
        state["params"] = _port(arch)
        state["opt"] = opt.init(state["params"])
        step = steps.make_train_step(cfg, opt)
        losses = []
        for b in _batches(arch):
            state, m = step(state, b)
            losses.append(float(m["loss"]))
        out[name] = {"losses": losses, "params": [t.detach().numpy()
                                                  for t in leaves(state["params"])]}
    return out


@functools.lru_cache(maxsize=None)
def _jax_loss_and_grads(arch):
    from repro.models import model as JM

    batch = {k: jnp.asarray(v) for k, v in _batches(arch)[0].items()}
    (loss, _), grads = jax.value_and_grad(
        lambda p: JM.loss_fn(_jax_cfg(arch), p, batch), has_aux=True)(
        jax.tree.map(jnp.asarray, _params(arch)))
    return float(loss), [np.asarray(g) for g in jax.tree.leaves(grads)]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    from repro_torch.optim import adamw
    from repro_torch.runtime import mesh, steps
    from repro_torch.runtime.runner import RunnerConfig, TrainRunner

    root = tmp_path_factory.mktemp("sharded")
    cfg = _cfg("olmo_1b")
    # a checkpoint written on one device, for the 2x2 restore
    one = TrainRunner(cfg, None, adamw(1e-3), RunnerConfig(str(root / "one"), ckpt_every=2),
                      device="cpu")
    one.run(lambda s: _batches("olmo_1b")[s % N_STEPS], 2)
    job = {
        "cases": {arch: {"cfg": _cfg(arch), "params": _params(arch), "batches": _batches(arch),
                         "meshes": meshes} for arch, meshes in CASES.items()},
        "sgd_lr": SGD_LR, "adamw_lr": ADAMW_LR,
        "ckpt": {"cfg": cfg, "batches": _batches("olmo_1b"), "dir": str(root / "mesh"),
                 "from_1x1": str(root / "one"), "from_1x1_step": 2},
        "slow_write": {"dir": str(root / "slow"), "timeout_s": SLOW_TIMEOUT_S,
                       "sleep_s": SLOW_WRITE_S},
    }
    out = mesh.launch(W.sharded_train, (2, 2), device="cpu", threads=1, quiet=True,
                      args=(job,), timeout=WORLD_TIMEOUT)
    out["ckpt_dir"] = root / "mesh"
    out["like"] = steps.abstract_train_state(cfg, adamw(1e-3))
    return out


def _rel(a, b) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def _assert_leaves_close(got, want, rtol, what):
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, (what, i)
        scale = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(g, w, rtol=0, atol=rtol * scale, err_msg=f"{what} leaf {i}")


CASE_IDS = [(arch, shape) for arch, meshes in CASES.items() for shape in meshes]


@pytest.mark.parametrize("arch, shape", CASE_IDS)
def test_loss_and_gradient_match_one_device_and_jax(world, arch, shape):
    got = world[(arch, shape)]["grad"]
    one = _one_device(arch)
    jl, jg = _jax_loss_and_grads(arch)
    assert _rel(got["loss"], one["loss"]) <= LOSS_RTOL, (got["loss"], one["loss"])
    assert _rel(got["loss"], jl) <= LOSS_RTOL, (got["loss"], jl)
    _assert_leaves_close(got["grads"], one["grads"], GRAD_RTOL, f"{arch} {shape} vs 1x1")
    _assert_leaves_close(got["grads"], jg, GRAD_RTOL, f"{arch} {shape} vs jax")
    if arch != "olmo_1b":
        assert got["moe_aux"] > 0.0


@pytest.mark.parametrize("arch, shape", CASE_IDS)
def test_sgd_and_adamw_steps_match_one_device(world, arch, shape):
    got, one = world[(arch, shape)], _one_device(arch)
    names = ("sgd", "adamw") if shape == (2, 2) else ("sgd",)
    assert ("adamw" in got) == (shape == (2, 2))
    for name in names:
        for a, b in zip(got[name]["losses"], one[name]["losses"]):
            assert _rel(a, b) <= LOSS_RTOL, (name, got[name]["losses"], one[name]["losses"])
    _assert_leaves_close(got["sgd"]["params"], one["sgd"]["params"], GRAD_RTOL,
                         f"{arch} {shape} sgd params")


def test_fault_replay_is_exact_and_checkpoints_cross_meshes(world):
    ck = world["ckpt"]
    assert ck["faults"] == 1 and ck["ckpt_steps"] == [2, 4]
    steps_run = [s for s, _ in ck["losses"]]
    assert steps_run == [0, 1, 2, 2, 3]
    assert ck["losses"][2][1] == ck["losses"][3][1]  # the replayed step, bit for bit
    for shape in ((1, 2), (2, 1), (1, 1), (2, 2)):
        assert ck[("from_2x2", shape)] is True, shape
    assert ck[("from_1x1", (2, 2))] is True


def test_a_slow_checkpoint_write_does_not_time_out_the_other_ranks(world):
    assert world["slow_write"] is True


def test_jax_reads_a_checkpoint_written_at_2x2(world):
    from repro.checkpoint import CheckpointManager as JaxManager
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.convert import train_state_to_numpy

    whole, step = CheckpointManager(world["ckpt_dir"]).restore(world["like"])
    assert step == 4
    like = train_state_to_numpy(whole)
    got, jstep = JaxManager(world["ckpt_dir"]).restore(like)
    assert jstep == 4
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(like)):
        np.testing.assert_array_equal(np.asarray(g), w)


# -- the CLI --------------------------------------------------------------------


@pytest.mark.parametrize("argv, match", [
    (["--arch", "xlstm_1p3b", "--mesh", "1x4"], "n_heads 2"),  # SMOKE's 2 heads over 4
    (["--arch", "hubert_xlarge", "--mesh", "1x2"], "item 4"),
    (["--arch", "phi3_vision_4p2b", "--mesh", "2x1"], "item 4"),
    (["--arch", "zamba2_1p2b", "--rescale-mesh", "2x1x2"], "item 5"),
    (["--arch", "granite_8b", "--mesh", "2x2x2"], "item 5"),
    (["--arch", "kimi_k2_1t_a32b", "--mesh", "2x1x2"], "item 5"),
    (["--mesh", "2x2x2"], "item 5"),
])
def test_cli_refuses_what_the_mesh_does_not_run(argv, match):
    from repro_torch.launch import train

    with pytest.raises(SystemExit, match=match):
        train.main(argv + ["--device", "cpu", "--steps", "1"])


@pytest.mark.parametrize("argv, match", [
    (["--arch", "xlstm_1p3b", "--mesh", "1x4"], "n_heads 2"),  # SMOKE's 2 heads over 4
    (["--arch", "hubert_xlarge", "--mesh", "1x2"], "item 4"),
    (["--arch", "phi3_vision_4p2b", "--mesh", "2x1"], "item 4"),
    (["--arch", "zamba2_1p2b", "--mesh", "2x1x2"], "item 5"),
    (["--arch", "granite_8b", "--mesh", "2x2x2"], "item 5"),
    (["--mesh", "2x2x2"], "item 5"),
])
def test_serve_refuses_what_the_mesh_does_not_run(argv, match):
    from repro_torch.launch import serve

    with pytest.raises(SystemExit, match=match):
        serve.main(argv + ["--device", "cpu", "--gen", "2"])


def test_a_rank_that_raises_fails_the_cli(tmp_path):
    """granite-moe with a batch of 3 over two data ranks: each rank raises
    splitting the batch in its first step."""
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "granite_moe_1b_a400m",
         "--device", "cpu", "--mesh", "2x1", "--steps", "1", "--batch", "3", "--seq", "15",
         "--ckpt-dir", str(tmp_path / "ckpt")],
        env={**__import__("os").environ, "PYTHONPATH": str(SRC)}, cwd=str(REPO),
        capture_output=True, text=True, timeout=WORLD_TIMEOUT)
    assert proc.returncode != 0
    assert "B % dp == 0 is needed" in proc.stderr and "(3 % 2)" in proc.stderr, \
        proc.stderr[-3000:]
