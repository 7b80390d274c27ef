"""The sequence-parallel residual (JAX's "seq" -> model) in sharded training
and prefill, against the replicated layout, the port's 1x1 step and JAX's
single-device loss and gradient.

One world of four gloo ranks on the CPU (module-scoped) runs, from the
same numpy params and batches as here (SMOKE configs, fp32), each case's
loss and gradient of one batch under the config's rules (the residual
sharded on its sequence over `model` where tp divides S) and under
rules_for(cfg, {"seq": None}) (replicated), with the bytes the remat
keeps a layer on rank 0 (model.remat_saved):

  * olmo_1b at 1x2, 2x2 and 1x4, and at 1x3 with S 12 (heads, ffn and
    vocabulary whole on every rank: the layers' replicated paths);
  * granite_moe_1b_a400m at 1x2 (the all-to-all path on the rank's
    slice), 1x4 (its two kv heads whole), 1x2 through the capacity
    dispatch (moe_impl "gather": the routing on the gathered tokens, the
    expert parts psum-scattered) and 1x3 with S 12 (E 8 whole: the
    capacity dispatch replicated over `model` on the gathered tokens);
  * kimi_k2_1t_a32b at 1x2 (a leading dense layer, a shared expert);
  * granite_8b with fsdp_embed on at 2x2 (FSDP and SP together);
  * olmo_1b and granite-moe at 1x2 with S 15 (no divide: replicated).

Each sharded layout's loss and gradients (averaged over `data`, gathered
whole) are held against the other's, the port's 1x1 and JAX's
value_and_grad(M.loss_fn) at RTOL; the SP layout keeps exactly 1/tp of
the replicated layout's bytes a layer; where S does not divide tp both
layouts are one, bit for bit.  Also: the norms' gradients at 1x2 against
1x1, and with their sum over `model` left out (planted) far from them;
make_train_step(rules={"seq": None}) bit for bit the step of a residual
forced replicated; a sharded prefill's logits and layer 0's K/V bit for
bit the replicated layout's, and the 1x1 prefill's and JAX's at RTOL;
launch/serve's rank body at 2x2 (SP prefill) against the 1x1 serve's
tokens.  The MoE configs run at capacity 4.0, where no token is dropped
(the all-to-all path and the capacity dispatch drop different tokens).
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
RTOL = 1e-5
B = 4
# name: (arch, mesh, S, config overrides beyond _overrides)
CASES = {
    "olmo 1x2": ("olmo_1b", (1, 2), 16, {}),
    "olmo 2x2": ("olmo_1b", (2, 2), 16, {}),
    "olmo 1x4": ("olmo_1b", (1, 4), 16, {}),
    "olmo 1x3 (heads, ffn, vocab whole)": ("olmo_1b", (1, 3), 12, {}),
    "granite-moe 1x2 (a2a)": ("granite_moe_1b_a400m", (1, 2), 16, {}),
    "granite-moe 1x4 (kv heads whole)": ("granite_moe_1b_a400m", (1, 4), 16, {}),
    "granite-moe 1x2 (capacity dispatch)": ("granite_moe_1b_a400m", (1, 2), 16,
                                            {"moe_impl": "gather"}),
    "granite-moe 1x3 (E whole: capacity dispatch)": ("granite_moe_1b_a400m", (1, 3), 12, {}),
    "kimi-k2 1x2": ("kimi_k2_1t_a32b", (1, 2), 16, {}),
    "granite-8b FSDP 2x2": ("granite_8b", (2, 2), 16, {"fsdp_embed": True}),
    "olmo 1x2, S 15 (replicated)": ("olmo_1b", (1, 2), 15, {}),
    "granite-moe 1x2, S 15 (replicated)": ("granite_moe_1b_a400m", (1, 2), 15, {}),
}
NORM_NAME = "granite-8b 1x2"
CASES[NORM_NAME] = NORM_CASE = ("granite_8b", (1, 2), 16, {})  # rms norms
PREFILL_CASE = ("granite_moe_1b_a400m", (2, 2), 16, {})
SERVE_CASE = ("olmo_1b", (2, 2), 10, 4)  # arch, mesh, prompt, gen


def _overrides(arch, extra):
    base = {} if arch in ("olmo_1b", "granite_8b") else {
        "capacity_factor": 4.0, "moe_wire_dtype": "native"}
    return {**base, **extra}


def _cfg(arch, extra=()):
    from repro_torch.configs import get_smoke_config

    return dataclasses.replace(get_smoke_config(arch), **_overrides(arch, dict(extra)))


def _jax_cfg(arch, extra=()):
    from repro.configs import get_smoke_config

    return dataclasses.replace(get_smoke_config(arch), **_overrides(arch, dict(extra)))


@functools.lru_cache(maxsize=None)
def _params(arch):
    from repro.models import model as JM
    from repro.models.layers import split_tree

    vals, _ = split_tree(JM.init(_jax_cfg(arch), jax.random.PRNGKey(0)))
    return jax.tree.map(np.asarray, vals)


def _batch(s, seed=7):
    rng = np.random.default_rng([seed, s])
    return {"tokens": rng.integers(0, 256, (B, s)).astype(np.int32)}


def _case(arch, shape, s, extra):
    return {"cfg": _cfg(arch, tuple(extra.items())), "params": _params(arch), "batch": _batch(s),
            "mesh": shape}


@pytest.fixture(scope="module")
def world():
    from repro_torch.launch import serve
    from repro_torch.runtime import mesh

    arch, shape, prompt, gen = SERVE_CASE
    norm = _case(*NORM_CASE)
    job = {"cases": {name: _case(*c) for name, c in CASES.items()},
           "planted": norm, "steps": {**norm, "batch": [_batch(16, i) for i in range(2)]},
           "prefill": _case(*PREFILL_CASE),
           "serve": {"cfg": _cfg(arch), "params": _params(arch), "mesh": shape,
                     "args": vars(serve.parse_args([
                         "--arch", arch, "--batch", "2", "--prompt-len", str(prompt),
                         "--gen", str(gen), "--device", "cpu", "--mesh", "2x2"]))}}
    return mesh.launch(W.sequence_parallel, (2, 2), device="cpu", threads=1, quiet=True,
                       args=(job,), timeout=WORLD_TIMEOUT)


def _one_device(arch, s, extra=()):
    return _port_reference(arch, s, _one_device_extra(extra))


@functools.lru_cache(maxsize=None)
def _port_reference(arch, s, extra):
    """The port's 1x1 loss and gradients of the case's batch."""
    from repro_torch.convert import lm_params_from_numpy
    from repro_torch.models import model
    from repro_torch.pytree import leaves

    cfg = _cfg(arch, extra)
    params = lm_params_from_numpy(cfg, _params(arch), device="cpu")
    flat = leaves(params)
    for p in flat:
        p.requires_grad_(True)
    loss, _ = model.loss_fn(cfg, params, {"tokens": torch.from_numpy(_batch(s)["tokens"])})
    return float(loss.detach()), [g.numpy() for g in torch.autograd.grad(loss, flat)]


# Overrides that leave one device's function as it is (the dispatch path
# and FSDP take effect on a mesh only): one reference serves such cases.
MESH_ONLY = ("moe_impl", "fsdp_embed")


def _one_device_extra(extra):
    return tuple((k, v) for k, v in extra if k not in MESH_ONLY)


def _jax_loss_and_grads(arch, s, extra=()):
    return _jax_reference(arch, s, _one_device_extra(extra))


@functools.lru_cache(maxsize=None)
def _jax_reference(arch, s, extra):
    from repro.models import model as JM

    batch = {k: jnp.asarray(v) for k, v in _batch(s).items()}
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p: JM.loss_fn(_jax_cfg(arch, extra), p, batch), has_aux=True))(
        jax.tree.map(jnp.asarray, _params(arch)))
    return float(loss), [np.asarray(g) for g in jax.tree.leaves(grads)]


def _rel(a, b) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def _close(got, want, what):
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, (what, i)
        scale = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(g, w, rtol=0, atol=RTOL * scale, err_msg=f"{what} leaf {i}")


@pytest.mark.parametrize("name", list(CASES))
def test_sp_matches_the_replicated_layout_one_device_and_jax(world, name):
    arch, shape, s, extra = CASES[name]
    extra = tuple(extra.items())
    got = world[name]
    divides = s % shape[1] == 0
    assert got["sp"]["axis"] == ("model" if divides else None)
    assert got["replicated"]["axis"] is None
    one_loss, one_grads = _one_device(arch, s, extra)
    jax_loss, jax_grads = _jax_loss_and_grads(arch, s, extra)
    for layout in ("sp", "replicated"):
        run = got[layout]
        assert _rel(run["loss"], one_loss) <= RTOL, (layout, run["loss"], one_loss)
        assert _rel(run["loss"], jax_loss) <= RTOL, (layout, run["loss"], jax_loss)
        _close(run["grads"], one_grads, f"{name} {layout} vs 1x1")
        _close(run["grads"], jax_grads, f"{name} {layout} vs jax")
    _close(got["sp"]["grads"], got["replicated"]["grads"], f"{name} sp vs replicated")
    if arch != "olmo_1b" and arch != "granite_8b":
        assert got["sp"]["moe_aux"] > 0.0


@pytest.mark.parametrize("name", list(CASES))
def test_remat_keeps_one_tpth_of_the_replicated_residual(world, name):
    _, shape, s, _ = CASES[name]
    sp, rep = world[name]["sp"]["saved"], world[name]["replicated"]["saved"]
    cfg = _cfg(CASES[name][0])
    assert len(sp) == len(rep) == cfg.n_layers
    b = B // shape[0]
    assert rep == [b * s * cfg.d_model * 4] * cfg.n_layers  # fp32 (B/dp, S, D)
    if s % shape[1] == 0:
        assert sp == [n // shape[1] for n in rep]
    else:
        assert sp == rep


@pytest.mark.parametrize("name", [n for n, c in CASES.items() if c[2] % c[1][1]])
def test_an_s_that_does_not_divide_tp_keeps_the_replicated_layout_bit_for_bit(world, name):
    got = world[name]
    assert got["sp"]["loss"] == got["replicated"]["loss"]
    for a, b in zip(got["sp"]["grads"], got["replicated"]["grads"]):
        np.testing.assert_array_equal(a, b)


def _paths(tree, prefix=""):
    """The path of each leaf of a logical-axes tree, in leaf order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _paths(tree[k], f"{prefix}/{k}")]
    return [prefix]


def test_norm_gradients_are_summed_over_model(world):
    """The norms' scales see only the rank's positions: their gradients at
    1x2 under SP equal 1x1's (the test above holds every leaf); without
    their sum over `model` (planted) they read about 1 - 1/tp of their
    scale."""
    from repro_torch.models import model

    arch, _, s, extra = NORM_CASE
    _, one_grads = _one_device(arch, s, tuple(extra.items()))
    paths = _paths(model.param_axes(_cfg(arch)))
    norms = [i for i, p in enumerate(paths) if "norm" in p]
    assert len(paths) == len(one_grads) and len(norms) == 3, paths  # norm1, norm2, final
    good, bad = world[NORM_NAME]["sp"]["grads"], world["planted"]["grads"]
    for i in norms:
        scale = float(np.abs(one_grads[i]).max())
        assert float(np.abs(good[i] - one_grads[i]).max()) <= RTOL * scale, paths[i]
        assert float(np.abs(bad[i] - one_grads[i]).max()) > 0.1 * scale, paths[i]
    others = [i for i in range(len(paths)) if i not in norms]
    for i in others:  # the fault touches the norms' gradients only
        np.testing.assert_array_equal(bad[i], good[i])


def test_make_train_step_with_seq_none_is_the_replicated_step_bit_for_bit(world):
    """make_train_step(rules=rules_for(cfg, {"seq": None})) installs its
    rules: two SGD steps equal, bit for bit, those of the config's rules
    with the layout decision forced to replicated, and the SP steps within
    RTOL."""
    got = world["steps"]
    assert got["seq_none"]["losses"] == got["forced"]["losses"]
    for a, b in zip(got["seq_none"]["params"], got["forced"]["params"]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(got["sp"]["losses"], got["forced"]["losses"]):
        assert _rel(a, b) <= RTOL
    _close(got["sp"]["params"], got["forced"]["params"], "sp vs replicated steps")


def test_sharded_prefill_is_the_replicated_layouts_bit_for_bit(world):
    """granite-moe at 2x2 (the all-to-all MoE on the slice): the last
    position's logits and layer 0's K/V under SP equal the replicated
    layout's bit for bit, and the 1x1 prefill's and JAX's within RTOL."""
    from repro.models import model as JM
    from repro_torch.convert import lm_params_from_numpy
    from repro_torch.models import model

    arch, _, s, extra = PREFILL_CASE
    got = world["prefill"]
    for name in ("logits", "k", "v"):
        np.testing.assert_array_equal(got["sp"][name], got["replicated"][name])
    cfg = _cfg(arch, tuple(extra.items()))
    batch = _batch(s)
    with torch.no_grad():
        logits, cache = model.prefill(cfg, lm_params_from_numpy(cfg, _params(arch), "cpu"),
                                      {"tokens": torch.from_numpy(batch["tokens"])})
    jlogits, jcache = JM.prefill(_jax_cfg(arch, tuple(extra.items())),
                                 jax.tree.map(jnp.asarray, _params(arch)),
                                 {"tokens": jnp.asarray(batch["tokens"])})
    layer0 = {n: t[0].numpy() for n, t in next(iter(cache.values())).items()}
    jlayer0 = {n: np.asarray(t[0]) for n, t in jcache["layers"].items()}
    _close([got["sp"]["logits"], got["sp"]["k"], got["sp"]["v"]],
           [logits[:, -1:].numpy(), layer0["k"], layer0["v"]], "prefill vs 1x1")
    _close([got["sp"]["logits"], got["sp"]["k"], got["sp"]["v"]],
           [np.asarray(jlogits[:, -1:]), jlayer0["k"], jlayer0["v"]], "prefill vs jax")
    np.testing.assert_array_equal(got["sp"]["logits"].argmax(-1), logits[:, -1:].argmax(-1))


def test_serve_under_sp_gives_the_one_device_tokens(world):
    """launch/serve's rank body at 2x2 (its prefill sequence-parallel, S 10
    over 2 model ranks): the 1x1 serve's tokens."""
    from unittest import mock

    from repro_torch.convert import lm_params_from_numpy
    from repro_torch.launch import serve

    arch, _, prompt, gen = SERVE_CASE
    cfg = _cfg(arch)
    with mock.patch.object(serve, "_config", lambda args: cfg), \
            mock.patch.object(serve.M, "init", lambda c, seed, device: lm_params_from_numpy(
                c, _params(arch), device=device)):
        run = serve.run(serve.parse_args(["--arch", arch, "--batch", "2", "--prompt-len",
                                          str(prompt), "--gen", str(gen), "--device", "cpu"]))
    got = world["serve"]
    np.testing.assert_array_equal(got["tokens"], run["tokens"].numpy())
    assert got["agree"] and got["layout"] == "seq"
