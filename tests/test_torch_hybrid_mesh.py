"""The hybrid family (zamba2) on a (data, model) mesh: tensor-parallel
Mamba2 mixers, the shared attention block, in sharded training, prefill
and decode, against the port's 1x1 runs and JAX's single-device loss,
gradient and model-level serve loop.

One world of four gloo ranks on the CPU (module-scoped,
`torch_mesh_workers.recurrent_mesh`) runs zamba2's SMOKE config (fp32),
from the same numpy params and batches as here:

  * the loss and every gradient of one batch at 1x2, 2x1 and 2x2, and at
    1x2 with a "mamba_tail" (5 layers over groups of 2), under the
    config's rules (the residual sharded on its sequence over `model`) and
    under rules_for(cfg, {"seq": None}) (replicated), against the 1x1
    loss_fn and jax.value_and_grad(M.loss_fn), with the bytes remat keeps
    a layer exactly 1/tp of the replicated layout's;
  * SGD steps at each mesh and AdamW and Adafactor steps at 2x2 (Adafactor
    on the segmented leaves) against the 1x1 steps;
  * the segmented cut of Mamba2's fused leaves at 2x2: each rank holds
    1/tp of every segment of in_proj ([z | x | B | C | dt]) and of the
    convolution ([x | B | C]), and every leaf gathers back bit for bit;
  * launch/serve's rank body at 2x2 (the attention cache sharded on its
    sequence, the Mamba2 state by heads and segments) and at 1x2 with an
    odd cache length (the attention cache by kv heads): tokens and every
    step's logits against the 1x1 serve, tokens against JAX's model-level
    loop, the prefill's last logits against JAX's, every cache leaf
    gathered whole against the 1x1 cache;
  * the runner at 2x2 (a fault, its exact replay), its checkpoint restored
    at 1x2, 2x1, 1x1 and 2x2 bit for bit and read by JAX's manager;
  * two planted faults, each rejected: the gated norm's sum of squares
    through g alone (its backward the identity), and in_proj cut in
    contiguous chunks.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_workers as W

WORLD_TIMEOUT = 300  # seconds the spawned world may run (launch raises past it)
ARCH = "zamba2_1p2b"
RTOL = 1e-5
B, S, N_STEPS = 4, 16, 2
SGD_LR, ADAMW_LR, ADAFACTOR_LR = 0.1, 1e-3, 1e-2
# name: (mesh, n_layers: None for the SMOKE config's 4)
LAYOUTS = {"1x2": ((1, 2), None), "2x1": ((2, 1), None), "2x2": ((2, 2), None),
           "1x2 with a mamba_tail": ((1, 2), 5)}
STEPS = {"1x2": ((1, 2), ("sgd",)), "2x1": ((2, 1), ("sgd",)),
         "2x2": ((2, 2), ("sgd", "adamw", "adafactor"))}
# name: (mesh, prompt, gen): 2x2's cache of 14 positions splits over 2 model
# ranks (sequence-sharded), 1x2's of 13 does not (kv heads)
SERVE = {"2x2 (attention cache by sequence)": ((2, 2), 10, 4),
         "1x2 (attention cache by kv heads)": ((1, 2), 9, 4)}
PLANTED = ("norm sum through g", "in_proj cut contiguously")


def _cfg(n_layers=None):
    from repro_torch.configs import get_smoke_config

    cfg = get_smoke_config(ARCH)
    return cfg if n_layers is None else dataclasses.replace(cfg, n_layers=n_layers)


def _jax_cfg(n_layers=None):
    from repro.configs import get_smoke_config

    cfg = get_smoke_config(ARCH)
    return cfg if n_layers is None else dataclasses.replace(cfg, n_layers=n_layers)


@functools.lru_cache(maxsize=None)
def _params(n_layers=None):
    from repro.models import model as JM
    from repro.models.layers import split_tree

    vals, _ = split_tree(JM.init(_jax_cfg(n_layers), jax.random.PRNGKey(0)))
    return jax.tree.map(np.asarray, vals)


def _batches():
    rng = np.random.default_rng(7)
    return [{"tokens": rng.integers(0, 256, (B, S)).astype(np.int32)} for _ in range(N_STEPS)]


def _serve_args(mesh, prompt, gen):
    from repro_torch.launch import serve

    return vars(serve.parse_args(["--arch", ARCH, "--batch", "2", "--prompt-len", str(prompt),
                                  "--gen", str(gen), "--device", "cpu",
                                  "--mesh", "x".join(map(str, mesh))]))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    from repro_torch.optim import adamw
    from repro_torch.runtime import mesh, steps
    from repro_torch.runtime.runner import RunnerConfig, TrainRunner

    root = tmp_path_factory.mktemp("hybrid_mesh")
    cfg = _cfg()
    one = TrainRunner(cfg, None, adamw(1e-3), RunnerConfig(str(root / "one"), ckpt_every=2),
                      device="cpu")
    one.run(lambda s: _batches()[s % N_STEPS], 2)  # for the restore at 2x2
    batch = _batches()[0]
    job = {
        "layouts": {name: {"cfg": _cfg(n), "params": _params(n), "batch": batch, "mesh": shape}
                    for name, (shape, n) in LAYOUTS.items()},
        "steps": {name: {"cfg": cfg, "params": _params(), "batches": _batches(), "mesh": shape,
                         "opts": opts} for name, (shape, opts) in STEPS.items()},
        "sgd_lr": SGD_LR, "adamw_lr": ADAMW_LR, "adafactor_lr": ADAFACTOR_LR,
        "planted": {fault: {"cfg": cfg, "params": _params(), "batch": batch, "mesh": (1, 2),
                            "fault": fault} for fault in PLANTED},
        "serve": {name: {"cfg": cfg, "params": _params(), "mesh": shape,
                         "args": _serve_args(shape, prompt, gen)}
                  for name, (shape, prompt, gen) in SERVE.items()},
        "cut": {"cfg": cfg, "params": _params(), "mesh": (2, 2)},
        "ckpt": {"cfg": cfg, "batches": _batches(), "dir": str(root / "mesh"),
                 "from_1x1": str(root / "one"), "from_1x1_step": 2},
    }
    out = mesh.launch(W.recurrent_mesh, (2, 2), device="cpu", threads=1, quiet=True,
                      args=(job,), timeout=WORLD_TIMEOUT)
    out["ckpt_dir"] = root / "mesh"
    out["like"] = steps.abstract_train_state(cfg, adamw(1e-3))
    return out


def _flat(tree):
    from repro_torch.pytree import leaves

    return leaves(tree)


@functools.lru_cache(maxsize=None)
def _one_device(n_layers=None):
    """The port's 1x1 loss and gradients of batch 0."""
    from repro_torch.convert import lm_params_from_numpy
    from repro_torch.models import model

    cfg = _cfg(n_layers)
    params = lm_params_from_numpy(cfg, _params(n_layers), device="cpu")
    flat = _flat(params)
    for p in flat:
        p.requires_grad_(True)
    loss, _ = model.loss_fn(cfg, params, {"tokens": torch.from_numpy(_batches()[0]["tokens"])})
    return float(loss.detach()), [g.numpy() for g in torch.autograd.grad(loss, flat)]


@functools.lru_cache(maxsize=None)
def _one_device_steps(opt_name):
    from repro_torch.convert import lm_params_from_numpy
    from repro_torch.optim import adafactor, adamw, sgd
    from repro_torch.runtime import steps

    opt = {"sgd": sgd(SGD_LR), "adamw": adamw(ADAMW_LR),
           "adafactor": adafactor(ADAFACTOR_LR)}[opt_name]
    cfg = _cfg()
    params = lm_params_from_numpy(cfg, _params(), device="cpu")
    state = {"params": params, "opt": opt.init(params), "step": torch.zeros((), dtype=torch.int32)}
    step = steps.make_train_step(cfg, opt)
    losses = []
    for b in _batches():
        state, m = step(state, b)
        losses.append(float(m["loss"]))
    return {"losses": losses, "params": [t.detach().numpy() for t in _flat(state["params"])]}


@functools.lru_cache(maxsize=None)
def _jax_loss_and_grads(n_layers=None):
    from repro.models import model as JM

    batch = {k: jnp.asarray(v) for k, v in _batches()[0].items()}
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p: JM.loss_fn(_jax_cfg(n_layers), p, batch), has_aux=True))(
        jax.tree.map(jnp.asarray, _params(n_layers)))
    return float(loss), [np.asarray(g) for g in jax.tree.leaves(grads)]


@functools.lru_cache(maxsize=None)
def _one_device_serve(prompt, gen):
    from unittest import mock

    from repro_torch.convert import lm_params_from_numpy
    from repro_torch.launch import serve

    cfg = _cfg()
    with mock.patch.object(serve, "_config", lambda args: cfg), \
            mock.patch.object(serve.M, "init", lambda c, seed, device: lm_params_from_numpy(
                c, _params(), device=device)):
        run = serve.run(serve.parse_args(["--arch", ARCH, "--batch", "2", "--prompt-len",
                                          str(prompt), "--gen", str(gen), "--device", "cpu"]))
    return {"tokens": run["tokens"].numpy(),
            "logits": [t.numpy() for t in [run["last_logits"]] + run["step_logits"]],
            "cache": {s: {n: t.numpy() for n, t in kv.items()} for s, kv in run["cache"].items()}}


@functools.lru_cache(maxsize=None)
def _jax_serve(prompt, gen):
    """JAX's single-device model-level loop on the serve's prompts: the
    prefill's last logits and the greedy tokens."""
    from repro.launch.serve import _merge_prefill_cache as jax_merge
    from repro.models import model as JM

    jcfg = _jax_cfg()
    vals = jax.tree.map(jnp.asarray, _params())
    prompts = jnp.asarray(np.random.default_rng(0).integers(0, jcfg.vocab, (2, prompt)),
                          jnp.int32)
    logits, pre = JM.prefill(jcfg, vals, {"tokens": prompts})
    cache = jax_merge(jcfg, JM.init_cache(jcfg, 2, prompt + gen), pre)
    step = jax.jit(functools.partial(JM.decode_step, jcfg))
    tok = jnp.argmax(logits[:, -1, :], axis=-1).astype(jnp.int32)[:, None]
    out = [tok]
    for i in range(gen - 1):
        lg, cache = step(vals, cache, tok, jnp.asarray(prompt + i, jnp.int32))
        tok = jnp.argmax(lg[:, -1, :], axis=-1).astype(jnp.int32)[:, None]
        out.append(tok)
    return np.asarray(logits[:, -1, :]), np.asarray(jnp.concatenate(out, 1))


def _rel(a, b) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def _worst(got, want) -> float:
    """The largest leaf error, each over its leaf's largest magnitude."""
    assert len(got) == len(want)
    return max(float(np.abs(g - w).max()) / max(float(np.abs(w).max()), 1e-30)
               for g, w in zip(got, want))


def _close_to_jax(got, one, jax_grads, what):
    """Each leaf within RTOL (of its scale) of JAX's beyond the 1x1 port's
    own distance to JAX: the port's 1x1 gradient is within 1e-4 of JAX's
    (tests/test_torch_hybrid.py), 2e-5 at the 5-layer cut; the mesh adds at
    most RTOL to that."""
    assert len(got) == len(one) == len(jax_grads), what
    for i, (g, o, w) in enumerate(zip(got, one, jax_grads)):
        scale = max(float(np.abs(w).max()), 1e-30)
        own = float(np.abs(o - w).max())
        np.testing.assert_allclose(g, w, rtol=0, atol=RTOL * scale + own,
                                   err_msg=f"{what} leaf {i}")


def _close(got, want, what):
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, (what, i, g.shape, w.shape)
        scale = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(g, w, rtol=0, atol=RTOL * scale, err_msg=f"{what} leaf {i}")


# -- what the mesh takes, and the segmented cut (no world) ---------------------


def test_the_mesh_takes_both_families_and_refuses_the_rest():
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.models import model

    for arch in ("zamba2_1p2b", "xlstm_1p3b"):
        for get in (get_config, get_smoke_config):
            for sizes in ({"data": 1, "model": 2}, {"data": 2, "model": 1},
                          {"data": 2, "model": 2}):
                model.check_mesh_supported(get(arch), sizes)
    assert model.MESH_FAMILIES == ("dense", "moe", "hybrid", "xlstm")
    for arch in ("phi3_vision_4p2b", "hubert_xlarge"):
        with pytest.raises(NotImplementedError, match="item 4"):
            model.check_mesh_supported(get_config(arch), {"data": 2, "model": 2})
    for arch in ("zamba2_1p2b", "xlstm_1p3b"):
        with pytest.raises(NotImplementedError, match="item 5"):
            model.check_mesh_supported(get_config(arch), {"pod": 2, "data": 1, "model": 2})
    with pytest.raises(NotImplementedError, match="n_heads 2 does not split over tp 4"):
        model.check_mesh_supported(get_smoke_config("xlstm_1p3b"), {"data": 1, "model": 4})
    # SMOKE: d_inner 128, d_state 8, 8 heads; at 16 model ranks B's 8 columns do not split
    with pytest.raises(NotImplementedError, match="segment B"):
        model.check_mesh_supported(_cfg(), {"data": 1, "model": 16})


def test_a_segment_the_axis_does_not_divide_is_never_cut_otherwise():
    from repro_torch.runtime import sharding

    name = sharding.Segmented("ssm_inner", (6, 2))  # 8 divides 4; 6 does not
    with pytest.raises(NotImplementedError, match=r"segment 0 of \(6, 2\)"):
        sharding.spec_for_axes({"data": 1, "model": 4}, (name,), (8,), sharding.rules_for(_cfg()))
    spec = sharding.spec_for_axes({"data": 1, "model": 2}, (name,), (8,),
                                  sharding.rules_for(_cfg()))
    assert spec == ("model",) and spec[0].segments == (6, 2)


def test_a_segmented_axis_is_cut_over_one_mesh_axis_only():
    """A Segmented name keeps its segments' names through spec_for_axes, and
    rules that give it two mesh axes raise (a cut over several would be
    contiguous)."""
    from repro_torch.runtime import sharding

    name = sharding.Segmented("ssm_inner", {"x": 8, "B": 4})
    spec = sharding.spec_for_axes({"data": 1, "model": 2}, (name,), (12,),
                                  sharding.rules_for(_cfg()))
    assert spec[0].names == ("x", "B") and spec[0].segments == (8, 4)
    rules = {**sharding.rules_for(_cfg()), "ssm_inner": ("data", "model")}
    with pytest.raises(NotImplementedError, match="over one mesh axis"):
        sharding.spec_for_axes({"data": 2, "model": 2}, (name,), (12,), rules)


def test_the_specs_are_jax_s_and_carry_the_segments():
    """in_proj's spec is JAX's (None, None, "model") a layer, its model part
    names the segments [z, x, B, C, dt]; conv_w, conv_b and Adafactor's vc
    of in_proj carry [x, B, C] / the same; the state's other specs are
    plain."""
    from repro_torch.models import model
    from repro_torch.optim import adafactor
    from repro_torch.runtime import steps

    cfg = _cfg()
    specs = model.param_specs(cfg, {"data": 2, "model": 2})["mamba"]["mixer"]
    assert specs["in_proj"] == (None, None, "model")
    assert specs["in_proj"][2].segments == (128, 128, 8, 8, 8)
    assert specs["conv_w"][2].segments == specs["conv_b"][1].segments == (128, 8, 8)
    assert not hasattr(specs["out_proj"][1], "segments")
    opt = steps.state_shardings(cfg, adafactor(0.1), {"data": 2, "model": 2})["opt"]
    f = opt["f"]["mamba"]["mixer"]
    assert f["in_proj"]["vc"] == (None, "model") and f["in_proj"]["vc"][1].segments[0] == 128
    assert f["in_proj"]["vr"] == (None, None)


def test_the_segmented_cut_round_trips_and_holds_each_segments_part(world):
    got = world["cut"]
    p = _params()["mamba"]["mixer"]
    whole = {"in_proj": p["in_proj"][0], "conv_w": p["conv_w"][0], "conv_b": p["conv_b"][0]}
    segs = {"in_proj": (128, 128, 8, 8, 8), "conv_w": (128, 8, 8), "conv_b": (128, 8, 8)}
    assert len(got) == 4
    for rank in got:
        assert rank["ok"], rank["coords"]
        r = rank["coords"]["model"]
        for name, t in whole.items():
            at, parts = 0, []
            for seg in segs[name]:
                parts.append(t[..., at + r * seg // 2: at + (r + 1) * seg // 2])
                at += seg
            np.testing.assert_array_equal(rank["parts"][name], np.concatenate(parts, -1))


# -- training ---------------------------------------------------------------------


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_loss_and_gradients_match_one_device_and_jax(world, name):
    _, n_layers = LAYOUTS[name]
    got = world[("layouts", name)]
    assert got["sp"]["axis"] == ("model" if LAYOUTS[name][0][1] > 1 else None)
    assert got["replicated"]["axis"] is None
    one_loss, one_grads = _one_device(n_layers)
    jax_loss, jax_grads = _jax_loss_and_grads(n_layers)
    for layout in ("sp", "replicated"):
        run = got[layout]
        assert _rel(run["loss"], one_loss) <= RTOL, (layout, run["loss"], one_loss)
        assert _rel(run["loss"], jax_loss) <= RTOL, (layout, run["loss"], jax_loss)
        _close(run["grads"], one_grads, f"{name} {layout} vs 1x1")
        _close_to_jax(run["grads"], one_grads, jax_grads, f"{name} {layout} vs jax")


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_remat_keeps_one_tpth_of_the_replicated_residual(world, name):
    (dp, tp), n_layers = LAYOUTS[name]
    cfg = _cfg(n_layers)
    sp, rep = world[("layouts", name)]["sp"]["saved"], world[("layouts", name)]["replicated"]["saved"]
    # every Mamba2 block and every application of the shared block
    assert len(sp) == len(rep) == cfg.n_layers + cfg.n_layers // cfg.attn_every
    assert rep == [B // dp * S * cfg.d_model * 4] * len(rep)  # fp32 (B/dp, S, D)
    assert sp == [n // tp for n in rep]


@pytest.mark.parametrize("name", list(STEPS))
def test_optimizer_steps_match_one_device(world, name):
    got = world[("steps", name)]
    for opt in STEPS[name][1]:
        one = _one_device_steps(opt)
        for a, b in zip(got[opt]["losses"], one["losses"]):
            assert _rel(a, b) <= RTOL, (opt, got[opt]["losses"], one["losses"])
        if opt != "adamw":  # AdamW turns rounding into updates on lr's scale
            _close(got[opt]["params"], one["params"], f"{name} {opt} params")


# -- serving --------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(SERVE))
def test_serve_matches_one_device_and_jax(world, name):
    shape, prompt, gen = SERVE[name]
    got, one = world[("serve", name)], _one_device_serve(prompt, gen)
    jax_last, jax_tokens = _jax_serve(prompt, gen)
    np.testing.assert_array_equal(got["tokens"], one["tokens"])
    np.testing.assert_array_equal(got["tokens"], jax_tokens)
    assert got["agree"]
    assert got["layout"] == ("seq" if (prompt + gen) % shape[1] == 0 else "heads")
    assert len(got["logits"]) == gen
    for i, (g, w) in enumerate(zip(got["logits"], one["logits"])):
        _close([g], [w], f"{name} step {i}")
    _close([got["logits"][0]], [jax_last], f"{name} prefill vs jax")
    assert set(got["cache"]) == set(one["cache"]) == {"attn", "mamba"}
    for stack, leaves in one["cache"].items():
        for leaf, want in leaves.items():
            _close([got["cache"][stack][leaf]], [want], f"{name} cache {stack}/{leaf}")
    local = got["local_cache"]
    assert local["mamba"]["S"][3] == 8 // shape[1]  # heads
    assert local["mamba"]["conv_buf"][-1] == (128 + 16) // shape[1]  # segments
    assert local["mamba"]["S"][2] == 2 // shape[0]  # rows


# -- checkpoints --------------------------------------------------------------------


def test_fault_replay_is_exact_and_checkpoints_cross_meshes(world):
    ck = world["ckpt"]
    assert ck["faults"] == 1 and ck["ckpt_steps"] == [2, 4]
    assert [s for s, _ in ck["losses"]] == [0, 1, 2, 2, 3]
    assert ck["losses"][2][1] == ck["losses"][3][1]  # the replayed step, bit for bit
    for shape in ((1, 2), (2, 1), (1, 1), (2, 2)):
        assert ck[("from_2x2", shape)] is True, shape
    assert ck[("from_1x1", (2, 2))] is True


@pytest.mark.parametrize("arch", [ARCH])
def test_jax_reads_a_checkpoint_written_at_2x2(world, arch):
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


# -- planted faults ---------------------------------------------------------------


@pytest.mark.parametrize("fault", PLANTED)
def test_planted_faults_are_rejected(world, fault):
    """Each fault fails the gradient check the mixer is held to above: its
    worst leaf far past RTOL of the 1x1 gradient (the norm's planted g
    leaves the forward, so the loss, as it was)."""
    bad = world[("planted", fault)]
    one_loss, one_grads = _one_device()
    assert _worst(bad["grads"], one_grads) > 1e3 * RTOL
    if fault == "norm sum through g":
        assert _rel(bad["loss"], one_loss) <= RTOL
    else:
        assert _rel(bad["loss"], one_loss) > 1e3 * RTOL
