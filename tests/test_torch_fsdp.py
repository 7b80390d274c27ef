"""FSDP of `embed` over `data` on a (data, model) mesh: the weights' embed dim
sharded over `data` and gathered before use (models/fsdp.py), against the
port's 1x1 path and JAX's single device.

One world of four gloo ranks on the CPU (module-scoped) runs the SMOKE
configs of granite_8b (dense) and qwen3_32b (dense, qk-norm) at 2x1 and
2x2, and kimi_k2_1t_a32b (MoE: a leading dense layer, a shared expert,
its experts FSDP-sharded through models/moe_a2a) at 2x2, each with
fsdp_embed=True (the SMOKE configs turn it off; their widths divide
`data`), from the same numpy params and batches as here:

  * the loss and every gradient of one batch (averaged over `data`,
    gathered whole) against jax.value_and_grad(M.loss_fn) and the port's
    1x1 loss_fn, at LOSS_RTOL / GRAD_RTOL;
  * three SGD and three AdamW steps against the 1x1 steps (losses; params
    after SGD); at kimi also three Adafactor steps (the optimizer for_arch
    gives its bf16-param config; the SMOKE config keeps fp32 params):
    losses and params against the 1x1 steps;
  * Adafactor's update on leaves cut (data, model), stacked (L, embed,
    ffn), and 1-D over `model`, two steps, against the update of the whole
    leaves at ADAFACTOR_RTOL;
  * the runner at 2x2 on granite's FSDP config: a checkpoint every 2, a
    fault at 3, the replay bit for bit; its checkpoint restored at 1x2,
    2x1, 1x1 and 2x2, a 1x1 checkpoint at 2x2; JAX's manager reads it;
  * launch/serve's rank body at 2x2 for granite and kimi (capacity 4.0,
    where the a2a prefill and the 1x1 capacity dispatch drop nothing):
    tokens equal to the 1x1 serve's and JAX's model-level loop's, every
    step's logits and the cache within 1e-5 of the 1x1 serve's;
  * the a2a layer with its experts, router and shared expert FSDP-sharded,
    at 2x2, against JAX's apply_moe_a2a (which shards them so on any mesh
    with a data axis): the native wire with drops (output, aux and
    gradients at 1e-5) and the int8 wire (Q8_RTOL).

The MoE configs run their native wire in the world but the a2a case
(tests/test_torch_moe_a2a.py's inputs).  Besides: the gather is the
identity without a mesh; the specs, not the shapes, say what is gathered;
the mesh accepts the FSDP configs and still refuses phi-3-vision and a
`pod` axis; launch/train and launch/serve take the three full FSDP configs
on a 2x2 mesh and refuse a `pod` axis (no weight made).
"""

import dataclasses
import functools
import pathlib
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_moe_a2a as A2A
import torch_mesh_workers as W
from conftest import subprocess_env
from test_torch_common import REPO

WORLD_TIMEOUT = 420  # seconds the spawned world may run (launch raises past it)
LOSS_RTOL = GRAD_RTOL = LOGITS_RTOL = CACHE_RTOL = 1e-5
ADAFACTOR_RTOL = 1e-6
Q8_RTOL = A2A.Q8_RTOL
B, S, N_STEPS = 4, 16, 3
SGD_LR, ADAMW_LR, ADAFACTOR_LR = 0.5, 1e-3, 1e-2
CASES = {
    "granite_8b": ((2, 1), (2, 2)),
    "qwen3_32b": ((2, 1), (2, 2)),
    "kimi_k2_1t_a32b": ((2, 2),),
}
ADAFACTOR_ARCH = "kimi_k2_1t_a32b"
SERVE_B, PROMPT, GEN = 2, 10, 6
SERVE = {"granite 2x2": ("granite_8b", (2, 2)), "kimi-k2 2x2": ("kimi_k2_1t_a32b", (2, 2))}
A2A_CASES = {"native": {"cf": 1.25, "wire": "native", "grads": True},
             "int8": {"cf": 4.0, "wire": "int8", "grads": False}}


def _overrides(arch):
    moe = {"capacity_factor": 4.0, "moe_wire_dtype": "native"} if arch == "kimi_k2_1t_a32b" \
        else {}
    return {"fsdp_embed": True, **moe}


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


def _optimizers(arch):
    from repro_torch.optim import adafactor, adamw, sgd

    opts = {"sgd": sgd(SGD_LR), "adamw": adamw(ADAMW_LR)}
    if arch == ADAFACTOR_ARCH:
        opts["adafactor"] = adafactor(ADAFACTOR_LR)
    return opts


@functools.lru_cache(maxsize=None)
def _one_device(arch):
    """The port's 1x1 loss and gradients of batch 0, and its runs of
    N_STEPS steps with each optimizer."""
    from repro_torch.models import model
    from repro_torch.pytree import leaves
    from repro_torch.runtime import steps

    cfg = _cfg(arch)
    params = _port(arch)
    flat = leaves(params)
    for p in flat:
        p.requires_grad_(True)
    loss, _ = model.loss_fn(cfg, params, {"tokens": torch.from_numpy(_batches(arch)[0]["tokens"])})
    out = {"loss": float(loss.detach()),
           "grads": [g.numpy() for g in torch.autograd.grad(loss, flat)]}
    for name, opt in _optimizers(arch).items():
        state = {"params": _port(arch), "step": torch.zeros((), dtype=torch.int32)}
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


# Adafactor on cut leaves: each leaf's shape and spec on the 2x2 mesh.
ADAFACTOR_LEAVES = {"matrix": ((8, 12), ("data", "model")),
                    "stacked": ((3, 8, 12), (None, "data", "model")),
                    "vector": ((16,), ("model",)),
                    "rows": ((6, 8), (None, "data"))}


def _adafactor_job():
    """The leaves start at 0 (no weight decay: the update does not read
    them), so each step's update is stored with the rounding of its own
    size, not of a larger param's."""
    rng = np.random.default_rng(5)
    leaves = {k: np.zeros(shape, np.float32) for k, (shape, _) in ADAFACTOR_LEAVES.items()}
    grads = [{k: (rng.standard_normal(shape) * 10.0 ** rng.uniform(-2, 1, shape)).astype(
        np.float32) for k, (shape, _) in ADAFACTOR_LEAVES.items()} for _ in range(2)]
    return {"leaves": leaves, "grads": grads, "lr": ADAFACTOR_LR,
            "specs": {k: spec for k, (_, spec) in ADAFACTOR_LEAVES.items()}}


def _serve_args(arch, mesh="1x1"):
    from repro_torch.launch import serve

    return serve.parse_args(["--arch", arch, "--batch", str(SERVE_B), "--prompt-len",
                             str(PROMPT), "--gen", str(GEN), "--device", "cpu", "--mesh", mesh])


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    from repro_torch.optim import adamw
    from repro_torch.runtime import mesh, steps
    from repro_torch.runtime.runner import RunnerConfig, TrainRunner

    root = tmp_path_factory.mktemp("fsdp")
    cfg = _cfg("granite_8b")
    # a checkpoint written on one device, for the 2x2 restore
    one = TrainRunner(cfg, None, adamw(1e-3), RunnerConfig(str(root / "one"), ckpt_every=2),
                      device="cpu")
    one.run(lambda s: _batches("granite_8b")[s % N_STEPS], 2)
    a2a_params, a2a_x = A2A._inputs()
    job = {
        "cases": {arch: {"cfg": _cfg(arch), "params": _params(arch), "batches": _batches(arch),
                         "meshes": meshes, "adafactor": arch == ADAFACTOR_ARCH}
                  for arch, meshes in CASES.items()},
        "sgd_lr": SGD_LR, "adamw_lr": ADAMW_LR, "adafactor_lr": ADAFACTOR_LR,
        "adafactor_leaves": _adafactor_job(),
        "ckpt": {"cfg": cfg, "batches": _batches("granite_8b"), "dir": str(root / "mesh"),
                 "from_1x1": str(root / "one"), "from_1x1_step": 2},
        "serve": {name: {"cfg": _cfg(arch), "params": _params(arch), "mesh": shape,
                         "args": vars(_serve_args(arch, "x".join(map(str, shape))))}
                  for name, (arch, shape) in SERVE.items()},
        "a2a": {"params": a2a_params, "x": a2a_x, "top_k": A2A.TOP_K, "cases": A2A_CASES},
    }
    out = mesh.launch(W.fsdp_world, (2, 2), device="cpu", threads=1, quiet=True,
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
    if arch == "kimi_k2_1t_a32b":
        assert got["moe_aux"] > 0.0


@pytest.mark.parametrize("arch, shape", CASE_IDS)
def test_sgd_and_adamw_steps_match_one_device(world, arch, shape):
    got, one = world[(arch, shape)], _one_device(arch)
    for name in ("sgd", "adamw"):
        for a, b in zip(got[name]["losses"], one[name]["losses"]):
            assert _rel(a, b) <= LOSS_RTOL, (name, got[name]["losses"], one[name]["losses"])
    _assert_leaves_close(got["sgd"]["params"], one["sgd"]["params"], GRAD_RTOL,
                         f"{arch} {shape} sgd params")


def test_adafactor_steps_on_shards_match_one_device(world):
    arch, shape = ADAFACTOR_ARCH, (2, 2)
    got, one = world[(arch, shape)]["adafactor"], _one_device(arch)
    for a, b in zip(got["losses"], one["adafactor"]["losses"]):
        assert _rel(a, b) <= LOSS_RTOL, (got["losses"], one["adafactor"]["losses"])
    _assert_leaves_close(got["params"], one["adafactor"]["params"], LOSS_RTOL,
                         "adafactor params")


@pytest.mark.parametrize("name", list(ADAFACTOR_LEAVES))
def test_adafactor_update_on_a_shard_equals_the_whole_leafs(world, name):
    from repro_torch.optim import adafactor

    job = _adafactor_job()
    opt = adafactor(job["lr"])
    whole = {k: torch.from_numpy(v.copy()) for k, v in job["leaves"].items()}
    state = opt.init(whole)
    keys = sorted(job["leaves"])
    for i, (g, got) in enumerate(zip(job["grads"], world["adafactor_leaves"])):
        before = whole[name].clone()
        opt.update({k: torch.from_numpy(v) for k, v in g.items()}, state, whole, i)
        want = (whole[name] - before).numpy()
        got_upd = got[keys.index(name)] - before.numpy()
        scale = float(np.abs(want).max())
        assert scale > 0
        np.testing.assert_allclose(got_upd, want, rtol=0, atol=ADAFACTOR_RTOL * scale,
                                   err_msg=f"{name} step {i}")


def test_fault_replay_is_exact_and_checkpoints_cross_meshes(world):
    ck = world["ckpt"]
    assert ck["faults"] == 1 and ck["ckpt_steps"] == [2, 4]
    assert [s for s, _ in ck["losses"]] == [0, 1, 2, 2, 3]
    assert ck["losses"][2][1] == ck["losses"][3][1]  # the replayed step, bit for bit
    for shape in ((1, 2), (2, 1), (1, 1), (2, 2)):
        assert ck[("from_2x2", shape)] is True, shape
    assert ck[("from_1x1", (2, 2))] is True


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


@functools.lru_cache(maxsize=None)
def _serve_one_device(arch):
    """The port's 1x1 serve of the same case (serve.run, in process)."""
    from unittest import mock

    from repro_torch.convert import lm_params_from_numpy
    from repro_torch.launch import serve

    cfg = _cfg(arch)
    with mock.patch.object(serve, "_config", lambda args: cfg), \
            mock.patch.object(serve.M, "init", lambda c, seed, device: lm_params_from_numpy(
                c, _params(arch), device=device)):
        run = serve.run(_serve_args(arch))
    return {"tokens": run["tokens"].numpy(),
            "logits": [t.numpy() for t in [run["last_logits"]] + run["step_logits"]],
            "cache": {s: {n: t.numpy() for n, t in kv.items()} for s, kv in run["cache"].items()}}


@functools.lru_cache(maxsize=None)
def _jax_tokens(arch):
    """JAX's single-device model-level loop on the same prompts."""
    from repro.launch.serve import _merge_prefill_cache as jax_merge
    from repro.models import model as JM
    from repro.runtime import steps as JS

    jcfg = _jax_cfg(arch)
    vals = jax.tree.map(jnp.asarray, _params(arch))
    prompts = jnp.asarray(np.random.default_rng(0).integers(0, jcfg.vocab, (SERVE_B, PROMPT)),
                          jnp.int32)
    logits, pre = JM.prefill(jcfg, vals, {"tokens": prompts})
    cache = jax_merge(jcfg, JM.init_cache(jcfg, SERVE_B, PROMPT + GEN), pre)
    step = jax.jit(JS.make_decode_step(jcfg))
    tok = jnp.argmax(logits[:, -1, :], axis=-1).astype(jnp.int32)[:, None]
    out = [tok]
    for i in range(GEN - 1):
        nxt, cache = step(vals, cache, tok, jnp.asarray(PROMPT + i, jnp.int32))
        tok = nxt[:, None]
        out.append(tok)
    return np.asarray(jnp.concatenate(out, 1))


def _close(got, want, rtol, what):
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale, err_msg=what)


@pytest.mark.parametrize("name", list(SERVE))
def test_serve_tokens_equal_one_device_and_jax(world, name):
    arch = SERVE[name][0]
    got = world[("serve", name)]
    np.testing.assert_array_equal(got["tokens"], _serve_one_device(arch)["tokens"])
    np.testing.assert_array_equal(got["tokens"], _jax_tokens(arch))
    assert got["agree"], "the model ranks' tokens differ"


@pytest.mark.parametrize("name", list(SERVE))
def test_serve_step_logits_and_cache_match_one_device(world, name):
    arch = SERVE[name][0]
    got, one = world[("serve", name)], _serve_one_device(arch)
    assert len(got["logits"]) == len(one["logits"]) == GEN
    for i, (g, w) in enumerate(zip(got["logits"], one["logits"])):
        _close(g, w, LOGITS_RTOL, f"{name} step {i}")
    assert set(got["cache"]) == set(one["cache"])
    for stack, kv in one["cache"].items():
        for n, w in kv.items():
            _close(got["cache"][stack][n], w, CACHE_RTOL, f"{name} cache {stack}/{n}")


@pytest.fixture(scope="module")
def jax_a2a(tmp_path_factory):
    """JAX's apply_moe_a2a at 2x2 (its experts, router and shared expert
    sharded over `data` by its shard_map) on tests/test_torch_moe_a2a.py's
    inputs."""
    path = tmp_path_factory.mktemp("a2a_fsdp")
    params, x = A2A._inputs()
    np.savez(path / "in.npz", x=x, **{k: v for k, v in params.items() if k != "shared"},
             **{"shared_" + k: v for k, v in params["shared"].items()})
    code = A2A._JAX.format(path=str(path), cases=A2A_CASES, meshes=((2, 2),), top_k=A2A.TOP_K,
                           e=A2A.E)
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                          env=subprocess_env(4), cwd=str(REPO), capture_output=True, text=True,
                          timeout=WORLD_TIMEOUT)
    assert proc.returncode == 0, proc.stdout + proc.stderr[-4000:]
    return dict(np.load(pathlib.Path(path) / "out.npz"))


def test_a2a_with_fsdp_experts_matches_jax_native_wire(world, jax_a2a):
    got = world[("a2a", "native")]
    _close(got["out"], jax_a2a["2x2/native/out"], A2A.FWD_RTOL, "out")
    assert _rel(got["aux"], float(jax_a2a["2x2/native/aux"])) <= A2A.FWD_RTOL
    jg = [jax_a2a[f"2x2/native/grad{i}"] for i in range(7)]
    assert len(got["grads"]) == len(jg)
    for i, (g, w) in enumerate(zip(got["grads"], jg)):
        _close(g, w, A2A.GRAD_RTOL, f"grad {i}")


def test_a2a_with_fsdp_experts_matches_jax_int8_wire(world, jax_a2a):
    from repro_torch.models.moe import moe_ref

    got = world[("a2a", "int8")]["out"]
    want = jax_a2a["2x2/int8/out"]
    _close(got, want, Q8_RTOL, "int8 out")
    params, x = A2A._inputs()
    p = {k: ({kk: torch.from_numpy(vv) for kk, vv in v.items()} if isinstance(v, dict)
             else torch.from_numpy(v)) for k, v in params.items()}
    ref = moe_ref(p, torch.from_numpy(x), top_k=A2A.TOP_K).numpy()
    assert float(np.abs(got - ref).max()) > 0.0  # the weights and the payload went int8


# -- without the world ---------------------------------------------------------------


def test_the_gather_is_the_identity_without_a_mesh():
    from repro_torch.models import fsdp, model
    from repro_torch.models import sharding_hook as hook

    t = torch.ones(4, 6)
    assert fsdp.gather(t, ("data", "model")) is t
    cfg = _cfg("granite_8b")
    with hook.installed(None):
        assert model._gather_specs(cfg, "layers") is None
        assert model._block_fn(cfg, "layers", len) is len


def test_the_specs_say_what_is_gathered():
    """At 2x2 every leaf with an `embed` axis holds it over `data` (d_model 64
    divides 2); at 2x3 (64 % 3 != 0) nothing does, and the layers gather
    nothing."""
    from repro_torch.models import fsdp, model
    from repro_torch.pytree import leaves

    for arch in CASES:
        cfg = _cfg(arch)
        is_axes = lambda x: isinstance(x, tuple)  # noqa: E731
        axes = leaves(model.param_axes(cfg), is_leaf=is_axes)
        specs = leaves(model.param_specs(cfg, {"data": 2, "model": 2}), is_leaf=is_axes)
        for ax, spec in zip(axes, specs):
            want = tuple(i for i, a in enumerate(ax) if a == "embed")
            assert fsdp.data_dims(spec) == want, (arch, ax, spec)
        assert not fsdp.any_sharded(model.param_specs(cfg, {"data": 3, "model": 2}))


def test_the_mesh_takes_fsdp_configs_and_refuses_the_rest():
    from repro_torch.configs import get_config
    from repro_torch.models import model

    for arch in ("granite_8b", "qwen3_32b", "kimi_k2_1t_a32b"):
        model.check_mesh_supported(get_config(arch), {"data": 2, "model": 2})
    with pytest.raises(NotImplementedError, match="item 4"):
        model.check_mesh_supported(get_config("phi3_vision_4p2b"), {"data": 2, "model": 2})
    with pytest.raises(NotImplementedError, match="item 5"):
        model.check_mesh_supported(get_config("granite_8b"), {"pod": 2, "data": 2, "model": 2})
    assert "fsdp" not in model.MESH_ITEMS


# -- the CLIs ------------------------------------------------------------------------


@pytest.mark.parametrize("cli", ["train", "serve"])
@pytest.mark.parametrize("arch", ["granite_8b", "qwen3_32b", "kimi_k2_1t_a32b"])
def test_the_clis_take_the_full_fsdp_configs_on_a_mesh(cli, arch):
    """`--full-config --mesh 2x2` is no longer refused for the three FSDP
    configs (their full configs set fsdp_embed; no weight is made here),
    while a `pod` axis still is."""
    import importlib

    mod = importlib.import_module(f"repro_torch.launch.{cli}")
    base = ["--arch", arch, "--full-config", "--device", "cpu"]
    cfg = mod._config(mod.parse_args(base + ["--mesh", "2x2"]))
    assert cfg.fsdp_embed and cfg.family in ("dense", "moe")
    with pytest.raises(SystemExit, match="item 5"):
        mod._config(mod.parse_args(base + ["--mesh", "2x2x2"]))
