"""The xlstm family on a (data, model) mesh: tensor-parallel mLSTM mixers,
the sLSTM (K3's path) on every model rank, in sharded training, prefill and
decode, against the port's 1x1 runs and JAX's single-device loss, gradient
and model-level serve loop.

One world of four gloo ranks on the CPU (module-scoped,
`torch_mesh_workers.recurrent_mesh`) runs xlstm-1.3b's SMOKE config
(fp32, 2 heads), from the same numpy params and batches as here:

  * the loss and every gradient of one batch at 1x2, 2x1 and 2x2 under the
    config's rules (the residual sharded on its sequence over `model`) and
    under rules_for(cfg, {"seq": None}) (replicated), against the 1x1
    loss_fn and jax.value_and_grad(M.loss_fn), with the bytes remat keeps
    an mLSTM block exactly 1/tp of the replicated layout's (the sLSTM
    block is not rematerialised, as JAX's);
  * SGD steps at each mesh and AdamW steps at 2x2 against the 1x1 steps;
  * launch/serve's rank body at 1x2 and 2x2 (the mLSTM state by heads, the
    sLSTM's the rank's rows): tokens and every step's logits against the
    1x1 serve, tokens against JAX's model-level loop, the prefill's last
    logits against JAX's, every cache leaf gathered whole against the 1x1
    cache;
  * a train step's `data` traffic at S 32 and S 64 at 2x2: the same
    collectives and bytes (the sLSTM's recurrence runs on the data rank's
    rows and its gradient is averaged over `data` once a step, the layout
    of JAX's manual-over-DP slstm_block_auto), while `model`'s grow with S;
  * three planted faults, each rejected: the output norm's sum of squares
    through g alone, the gates through g in place of the head-dim
    psum-scatter, and f_bias indexed without f.

The sLSTM input-gate bias has an exact gradient of zero (h is invariant
under a constant shift of raw_i), so its leaf is held at its sibling
r_i's scale, as tests/test_torch_xlstm.py holds it.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_workers as W

WORLD_TIMEOUT = 300  # seconds the spawned world may run (launch raises past it)
ARCH = "xlstm_1p3b"
RTOL = 1e-5
B, S, N_STEPS = 4, 16, 2
SGD_LR, ADAMW_LR = 0.1, 1e-3
LAYOUTS = {"1x2": (1, 2), "2x1": (2, 1), "2x2": (2, 2)}
STEPS = {"1x2": ((1, 2), ("sgd",)), "2x1": ((2, 1), ("sgd",)), "2x2": ((2, 2), ("sgd", "adamw"))}
SERVE = {"1x2": ((1, 2), 10, 4), "2x2": ((2, 2), 10, 4)}  # mesh, prompt, gen
PLANTED = ("norm sum through g", "gates through g", "f_bias without f")
TRAFFIC_S = (32, 64)


def _cfg():
    from repro_torch.configs import get_smoke_config

    return get_smoke_config(ARCH)


def _jax_cfg():
    from repro.configs import get_smoke_config

    return get_smoke_config(ARCH)


@functools.lru_cache(maxsize=None)
def _params():
    from repro.models import model as JM
    from repro.models.layers import split_tree

    vals, _ = split_tree(JM.init(_jax_cfg(), jax.random.PRNGKey(0)))
    return jax.tree.map(np.asarray, vals)


def _batch(s, seed=7, i=0):
    rng = np.random.default_rng([seed, s, i])
    return {"tokens": rng.integers(0, 256, (B, s)).astype(np.int32)}


def _batches():
    return [_batch(S, i=i) for i in range(N_STEPS)]


def _serve_args(mesh, prompt, gen):
    from repro_torch.launch import serve

    return vars(serve.parse_args(["--arch", ARCH, "--batch", "2", "--prompt-len", str(prompt),
                                  "--gen", str(gen), "--device", "cpu",
                                  "--mesh", "x".join(map(str, mesh))]))


@pytest.fixture(scope="module")
def world():
    from repro_torch.runtime import mesh

    cfg, batch = _cfg(), _batches()[0]
    job = {
        "layouts": {name: {"cfg": cfg, "params": _params(), "batch": batch, "mesh": shape}
                    for name, shape in LAYOUTS.items()},
        "steps": {name: {"cfg": cfg, "params": _params(), "batches": _batches(), "mesh": shape,
                         "opts": opts} for name, (shape, opts) in STEPS.items()},
        "sgd_lr": SGD_LR, "adamw_lr": ADAMW_LR, "adafactor_lr": None,
        "planted": {fault: {"cfg": cfg, "params": _params(), "batch": batch, "mesh": (1, 2),
                            "fault": fault} for fault in PLANTED},
        "serve": {name: {"cfg": cfg, "params": _params(), "mesh": shape,
                         "args": _serve_args(shape, prompt, gen)}
                  for name, (shape, prompt, gen) in SERVE.items()},
        "traffic": {"cfg": cfg, "params": _params(), "mesh": (2, 2),
                    "batches": {s: _batch(s) for s in TRAFFIC_S}},
    }
    return mesh.launch(W.recurrent_mesh, (2, 2), device="cpu", threads=1, quiet=True,
                       args=(job,), timeout=WORLD_TIMEOUT)


def _flat(tree):
    from repro_torch.pytree import leaves

    return leaves(tree)


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _paths(tree[k], f"{prefix}/{k}")]
    return [prefix]


def _param_axes():
    from repro_torch.models import model

    return model.param_axes(_cfg())


def _scales(want) -> list:
    """Each leaf's scale: its largest magnitude; the sLSTM input-gate
    bias's (an exact gradient of zero) that of its sibling r_i."""
    paths = _paths(_param_axes())
    assert len(paths) == len(want)
    at = {p: i for i, p in enumerate(paths)}
    return [max(float(np.abs(want[at[p.replace("/b_i", "/r_i")]]).max()), 1e-30)
            for p in paths]


@functools.lru_cache(maxsize=None)
def _one_device():
    from repro_torch.convert import lm_params_from_numpy
    from repro_torch.models import model

    cfg = _cfg()
    params = lm_params_from_numpy(cfg, _params(), device="cpu")
    flat = _flat(params)
    for p in flat:
        p.requires_grad_(True)
    loss, _ = model.loss_fn(cfg, params, {"tokens": torch.from_numpy(_batches()[0]["tokens"])})
    return float(loss.detach()), [g.numpy() for g in torch.autograd.grad(loss, flat)]


@functools.lru_cache(maxsize=None)
def _one_device_steps(opt_name):
    from repro_torch.convert import lm_params_from_numpy
    from repro_torch.optim import adamw, sgd
    from repro_torch.runtime import steps

    opt = {"sgd": sgd(SGD_LR), "adamw": adamw(ADAMW_LR)}[opt_name]
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
def _jax_loss_and_grads():
    from repro.models import model as JM

    batch = {k: jnp.asarray(v) for k, v in _batches()[0].items()}
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p: JM.loss_fn(_jax_cfg(), p, batch), has_aux=True))(
        jax.tree.map(jnp.asarray, _params()))
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
    """The largest leaf error, each over its leaf's scale (`_scales`)."""
    return max(float(np.abs(g - w).max()) / sc for g, w, sc in zip(got, want, _scales(want)))


def _close_grads(got, want, what):
    for i, (g, w, sc) in enumerate(zip(got, want, _scales(want))):
        assert g.shape == w.shape, (what, i)
        np.testing.assert_allclose(g, w, rtol=0, atol=RTOL * sc, err_msg=f"{what} leaf {i}")


def _close(got, want, what):
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=RTOL * scale, err_msg=what)


# -- training ---------------------------------------------------------------------


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_loss_and_gradients_match_one_device_and_jax(world, name):
    got = world[("layouts", name)]
    assert got["sp"]["axis"] == ("model" if LAYOUTS[name][1] > 1 else None)
    assert got["replicated"]["axis"] is None
    one_loss, one_grads = _one_device()
    jax_loss, jax_grads = _jax_loss_and_grads()
    for layout in ("sp", "replicated"):
        run = got[layout]
        assert _rel(run["loss"], one_loss) <= RTOL, (layout, run["loss"], one_loss)
        assert _rel(run["loss"], jax_loss) <= RTOL, (layout, run["loss"], jax_loss)
        _close_grads(run["grads"], one_grads, f"{name} {layout} vs 1x1")
        _close_grads(run["grads"], jax_grads, f"{name} {layout} vs jax")


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_remat_keeps_one_tpth_of_the_replicated_residual(world, name):
    dp, tp = LAYOUTS[name]
    cfg = _cfg()
    sp, rep = world[("layouts", name)]["sp"]["saved"], world[("layouts", name)]["replicated"]["saved"]
    n_mlstm = cfg.n_layers // cfg.slstm_every * (cfg.slstm_every - 1)
    assert len(sp) == len(rep) == n_mlstm  # the sLSTM block is not rematerialised
    assert rep == [B // dp * S * cfg.d_model * 4] * n_mlstm  # fp32 (B/dp, S, D)
    assert sp == [n // tp for n in rep]


@pytest.mark.parametrize("name", list(STEPS))
def test_optimizer_steps_match_one_device(world, name):
    got = world[("steps", name)]
    for opt in STEPS[name][1]:
        one = _one_device_steps(opt)
        for a, b in zip(got[opt]["losses"], one["losses"]):
            assert _rel(a, b) <= RTOL, (opt, got[opt]["losses"], one["losses"])
    # the params after the SGD steps; b_i (zero at the start) is its update,
    # held at the scale of r_i's update
    start = jax.tree.leaves(_params())
    got, one = world[("steps", name)]["sgd"]["params"], _one_device_steps("sgd")["params"]
    upd = _scales([w - p0 for w, p0 in zip(one, start)])
    for i, (g, w, p) in enumerate(zip(got, one, _paths(_param_axes()))):
        scale = upd[i] if p.endswith("/b_i") else max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(g, w, rtol=0, atol=RTOL * scale, err_msg=f"{name} {p}")


def test_the_data_traffic_of_a_step_does_not_depend_on_s(world):
    got = world["traffic"]
    short, long = got[TRAFFIC_S[0]], got[TRAFFIC_S[1]]
    assert short["data"] == long["data"] and short["data"][0] > 0
    assert long["model"][1] > short["model"][1]  # the sequence's gathers grow with S


def test_heads_the_model_axis_does_not_divide_are_refused():
    from repro_torch.models import model
    from repro_torch.optim import sgd
    from repro_torch.runtime import steps

    cfg = _cfg()
    for entry in (lambda: model.check_mesh_supported(cfg, {"data": 1, "model": 4}),
                  lambda: model.init_cache(cfg, 4, 8, "cpu", {"data": 1, "model": 4}),
                  lambda: steps.init_train_state(cfg, sgd(0.1), 0, "cpu",
                                                 {"data": 1, "model": 4})):
        with pytest.raises(NotImplementedError, match="n_heads 2 does not split over tp 4"):
            entry()


# -- serving --------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(SERVE))
def test_serve_matches_one_device_and_jax(world, name):
    shape, prompt, gen = SERVE[name]
    got, one = world[("serve", name)], _one_device_serve(prompt, gen)
    jax_last, jax_tokens = _jax_serve(prompt, gen)
    np.testing.assert_array_equal(got["tokens"], one["tokens"])
    np.testing.assert_array_equal(got["tokens"], jax_tokens)
    assert got["agree"] and got["layout"] == "heads"
    assert len(got["logits"]) == gen
    for i, (g, w) in enumerate(zip(got["logits"], one["logits"])):
        _close(g, w, f"{name} step {i}")
    _close(got["logits"][0], jax_last, f"{name} prefill vs jax")
    assert set(got["cache"]) == set(one["cache"]) == {"mlstm", "slstm"}
    for stack, leaves in one["cache"].items():
        for leaf, want in leaves.items():
            _close(got["cache"][stack][leaf], want, f"{name} cache {stack}/{leaf}")
    local = got["local_cache"]
    dp, tp = shape
    assert local["mlstm"]["C"][2:4] == (2 // dp, 2 // tp)  # rows, heads
    assert local["mlstm"]["conv_buf"][-1] == 128 // tp
    assert local["slstm"]["h"][1:] == (2 // dp, 64)


# -- planted faults ---------------------------------------------------------------


@pytest.mark.parametrize("fault", PLANTED)
def test_planted_faults_are_rejected(world, fault):
    """Each fault leaves the forward (so the loss) as it was and fails the
    gradient check above: its worst leaf far past RTOL of the 1x1
    gradient."""
    bad = world[("planted", fault)]
    one_loss, one_grads = _one_device()
    assert _rel(bad["loss"], one_loss) <= RTOL
    assert _worst(bad["grads"], one_grads) > 1e3 * RTOL
