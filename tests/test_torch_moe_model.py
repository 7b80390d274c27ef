"""Port parity: the MoE family (configs, models/model.py with the MoE blocks,
convert, the train step, the checkpoint) against the JAX package.

For the smoke configs of granite_moe_1b_a400m (32 experts top-8 cut to 8
top-2, two dispatch groups) and kimi_k2_1t_a32b (a dense first layer, a
shared expert, head dim 16), JAX's params (`M.init`, numpy-mapped) cross
with `convert.lm_params_from_numpy`, and the port is held against JAX in
fp32 (the smoke configs compute in fp32):
  * CONFIG and SMOKE equal JAX's (fields and parameter counts); `init`
    gives JAX's tree and shapes ("dense_layers", "moe", "shared");
  * forward (attention at impl "pallas", the TPU kernel in interpret mode,
    and "blockwise"), prefill (the "dense" and "layers" caches) and 4
    decode steps at 1e-4, the summed aux at 1e-6;
  * loss_fn's total, ce and moe_aux (1e-5 relative) and every gradient
    (1e-4 of its leaf's largest |value|), remat on and off;
  * granite: 3 SGD steps through make_train_step (params at 1e-4) and 3
    AdamW steps (losses at 1e-5, updates on the scale of lr); kimi with
    bf16 params on both sides (Adafactor through for_arch): losses within
    BF16_LOSS_RTOL;
  * a train state the port saves has JAX's leaf order ("dense_layers"
    before "embed") and restores bit for bit, in the port and in JAX.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import assert_close, to_jax, to_torch

TOL, AUX_TOL, LOSS_RTOL, GRAD_TOL = 1e-4, 1e-6, 1e-5, 1e-4
ARCHS = ["granite_moe_1b_a400m", "kimi_k2_1t_a32b"]
B, P, STEPS = 2, 12, 4  # batch, prompt, decode steps
# Updates of AdamW after three steps, in units of lr (test_torch_train.py's rule).
ADAMW_TYPICAL, ADAMW_MAX = 1e-3, 0.5
# kimi with bf16 params: both sides compute in fp32 from the same bf16
# values, and each update rounds the params to bf16; where the two fp32
# updates straddle a rounding boundary an element lands one bf16 ulp (2^-8
# relative) apart, which moves a later loss by far less than 2^-8 relative
# (measured: 0, 8.0e-8, 1.2e-5 over the three steps).
BF16_LOSS_RTOL = 2.0 ** -8


@functools.lru_cache(maxsize=None)
def _setup(arch, param_dtype="float32"):
    """(JAX cfg, JAX params, port cfg, port params, prompt tokens)."""
    from repro.configs import get_smoke_config as jax_smoke
    from repro.models import model as JM
    from repro.models.layers import split_tree
    from repro_torch.configs import get_smoke_config
    from repro_torch.convert import lm_params_from_numpy

    jcfg = dataclasses.replace(jax_smoke(arch), param_dtype=param_dtype)
    cfg = dataclasses.replace(get_smoke_config(arch), param_dtype=param_dtype)
    vals, _ = split_tree(JM.init(jcfg, jax.random.PRNGKey(0)))
    params = lm_params_from_numpy(cfg, jax.tree.map(np.asarray, vals), device="cpu")
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (B, P)).astype(np.int32)
    return jcfg, vals, cfg, params, toks


def _M():
    from repro_torch.models import model

    return model


def _shapes(tree) -> dict:
    return {jax.tree_util.keystr(p): tuple(np.shape(v))
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_the_jax_ones(arch):
    from repro.configs import get_config as jax_config
    from repro.configs import get_smoke_config as jax_smoke
    from repro_torch.configs import get_config, get_smoke_config

    for ours, theirs in ((get_config(arch), jax_config(arch)),
                         (get_smoke_config(arch), jax_smoke(arch))):
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
        assert ours.param_counts() == theirs.param_counts()
    full = get_config(arch)
    assert full.family == "moe" and full.cdtype == torch.bfloat16
    if arch == "kimi_k2_1t_a32b":
        assert full.dtype == torch.bfloat16 and full.resolved_head_dim == 112
        assert full.first_dense == 1 and full.n_shared_experts == 1
    else:
        assert full.dtype == torch.float32 and full.resolved_head_dim == 64


@pytest.mark.parametrize("arch,param_dtype", [(ARCHS[0], "float32"), (ARCHS[1], "float32"),
                                              (ARCHS[1], "bfloat16")])
def test_init_and_conversion_give_the_jax_tree(arch, param_dtype):
    _, vals, cfg, params, _ = _setup(arch, param_dtype)
    for tree in (_M().init(cfg, seed=0, device="cpu"), params):
        assert _shapes(tree) == _shapes(vals)
        assert {t.dtype for t in jax.tree.leaves(tree)} == {cfg.dtype}
    top = set(vals)
    assert ("dense_layers" in top) == (arch == "kimi_k2_1t_a32b")
    assert "moe" in vals["layers"] and "mlp" not in vals["layers"]
    assert ("shared" in vals["layers"]["moe"]) == (arch == "kimi_k2_1t_a32b")
    for got, w in zip(jax.tree.leaves(params), jax.tree.leaves(vals)):  # JAX's values
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(w, np.float32))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("impl", ["pallas", "blockwise"])
def test_forward_matches_jax(arch, impl):
    from repro.models import model as JM

    jcfg, vals, cfg, params, toks = _setup(arch)
    want, want_aux = JM.forward(dataclasses.replace(jcfg, attn_impl=impl), vals,
                                {"tokens": to_jax(toks)})
    got, aux = _M().forward(dataclasses.replace(cfg, attn_impl=impl), params,
                            {"tokens": to_torch(toks)})
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, P, cfg.vocab)
    assert_close(got, want, rtol=TOL, atol=TOL)
    assert float(want_aux) > 0 and abs(float(aux) - float(want_aux)) <= AUX_TOL


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_steps_match_jax(arch):
    from repro.models import model as JM
    from repro_torch.launch.serve import _merge_prefill_cache

    jcfg, vals, cfg, params, toks = _setup(arch)
    jlogits, jpre = JM.prefill(jcfg, vals, {"tokens": to_jax(toks)})
    logits, pre = _M().prefill(cfg, params, {"tokens": to_torch(toks)})
    assert_close(logits, jlogits, rtol=TOL, atol=TOL, what="prefill logits")
    stacks = {"dense": cfg.first_dense, "layers": cfg.n_layers - cfg.first_dense}
    stacks = {k: n for k, n in stacks.items() if n}
    assert set(pre) == set(jpre) == set(stacks)
    for stack, n in stacks.items():
        for name in ("k", "v"):
            assert tuple(pre[stack][name].shape) == (n, B, P, cfg.n_kv_heads,
                                                     cfg.resolved_head_dim)
            assert_close(pre[stack][name], jpre[stack][name], rtol=TOL, atol=TOL,
                         what=f"prefill cache {stack} {name}")

    jcache = jax.tree.map(
        lambda full, part: jax.lax.dynamic_update_slice(full, part.astype(full.dtype),
                                                        (0,) * full.ndim),
        JM.init_cache(jcfg, B, P + STEPS + 1), jpre)
    cache = _merge_prefill_cache(cfg, _M().init_cache(cfg, B, P + STEPS + 1, device="cpu"), pre)
    step = jax.jit(functools.partial(JM.decode_step, jcfg))
    tok = jnp.argmax(jlogits[:, -1, :], axis=-1).astype(jnp.int32)[:, None]
    for i in range(STEPS):  # JAX's greedy tokens, fed to both
        jlg, jcache = step(vals, jcache, tok, jnp.asarray(P + i, jnp.int32))
        lg, cache = _M().decode_step(cfg, params, cache, to_torch(np.asarray(tok)), P + i)
        assert_close(lg, jlg, rtol=TOL, atol=TOL, what=f"decode step {i}")
        tok = jnp.argmax(jlg[:, -1, :], axis=-1).astype(jnp.int32)[:, None]
    for stack in stacks:
        for name in ("k", "v"):
            assert_close(cache[stack][name], jcache[stack][name], rtol=TOL, atol=TOL,
                         what=f"final cache {stack} {name}")


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradient_match_jax(arch, remat):
    from repro.models import model as JM
    from repro_torch.pytree import leaves, unflatten

    jcfg, vals, cfg, params, _ = _setup(arch)
    jcfg, cfg = (dataclasses.replace(c, remat=remat) for c in (jcfg, cfg))
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (B, 16)).astype(np.int32)
    (jl, jm), jg = jax.value_and_grad(lambda p: JM.loss_fn(jcfg, p, {"tokens": toks}),
                                      has_aux=True)(vals)
    flat = [t.clone().requires_grad_(True) for t in leaves(params)]
    loss, metrics = _M().loss_fn(cfg, unflatten(params, flat), {"tokens": torch.from_numpy(toks)})
    grads = torch.autograd.grad(loss, flat)
    for got, want in ((loss.detach(), jl), (metrics["ce"].detach(), jm["ce"]),
                      (metrics["moe_aux"].detach(), jm["moe_aux"])):
        assert abs(float(got) - float(want)) <= LOSS_RTOL * abs(float(want))
    assert float(metrics["moe_aux"].detach()) > 0
    jflat = jax.tree.leaves(jg)
    assert len(jflat) == len(grads)
    for g, w in zip(grads, jflat):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=GRAD_TOL * max(float(np.abs(w).max()), 1e-30))


def _three_steps(arch, jopt, topt, param_dtype="float32"):
    """Three train steps of JAX's jitted step and the port's from one state:
    (JAX state, port state, JAX losses, port losses, initial params)."""
    from repro.configs import get_smoke_config as jax_smoke
    from repro.runtime import steps as JS
    from repro_torch.configs import get_smoke_config
    from repro_torch.convert import train_state_from_numpy
    from repro_torch.launch.train import make_batches
    from repro_torch.runtime import steps

    jcfg = dataclasses.replace(jax_smoke(arch), param_dtype=param_dtype)
    cfg = dataclasses.replace(get_smoke_config(arch), param_dtype=param_dtype)
    jstate = JS.init_train_state(jcfg, jopt, jax.random.PRNGKey(0))
    state = train_state_from_numpy(cfg, jax.tree.map(np.asarray, jstate), device="cpu")
    p0 = [np.asarray(x, np.float32) for x in jax.tree.leaves(jstate["params"])]
    jstep, step = jax.jit(JS.make_train_step(jcfg, jopt)), steps.make_train_step(cfg, topt)
    batches = make_batches(cfg, 4, 24, seed=0)
    jl, tl = [], []
    for i in range(3):
        jstate, jm = jstep(jstate, {"tokens": jnp.asarray(batches(i)["tokens"])})
        state, m = step(state, batches(i))
        jl.append(float(jm["loss"]))
        tl.append(float(m["loss"]))
        assert float(m["moe_aux"]) > 0
        assert abs(float(m["moe_aux"]) - float(jm["moe_aux"])) <= LOSS_RTOL * float(jm["moe_aux"])
    return jstate, state, jl, tl, p0


@pytest.mark.parametrize("which", ["sgd", "adamw"])
def test_granite_train_steps_match_jax(which):
    from repro.optim import adamw as jadamw, sgd as jsgd
    from repro_torch.convert import train_state_to_numpy
    from repro_torch.optim import adamw, sgd

    lr = 0.5 if which == "sgd" else 1e-3
    jopt, topt = (jsgd(lr), sgd(lr)) if which == "sgd" else (jadamw(lr), adamw(lr))
    jstate, state, jl, tl, p0 = _three_steps(ARCHS[0], jopt, topt)
    for a, b in zip(tl, jl):
        assert abs(a - b) <= LOSS_RTOL * abs(b)
    back = train_state_to_numpy(state)
    for got, want, start in zip(jax.tree.leaves(back["params"]),
                                jax.tree.leaves(jstate["params"]), p0):
        want = np.asarray(want)
        if which == "sgd":
            scale = max(float(np.abs(want).max()), 1e-30)
            np.testing.assert_allclose(got, want, rtol=0, atol=GRAD_TOL * scale)
        else:
            d = np.abs((got - start) - (want - start))
            assert float(d.max()) <= ADAMW_MAX * lr, float(d.max()) / lr
            assert float(np.mean(d > ADAMW_TYPICAL * lr)) <= 1e-3


def test_kimi_bf16_params_train_with_adafactor_like_jax():
    from repro.configs import get_smoke_config as jax_smoke
    from repro.optim.optimizers import for_arch as jax_for_arch
    from repro_torch.configs import get_smoke_config
    from repro_torch.optim import for_arch

    jcfg = dataclasses.replace(jax_smoke(ARCHS[1]), param_dtype="bfloat16")
    cfg = dataclasses.replace(get_smoke_config(ARCHS[1]), param_dtype="bfloat16")
    jopt, topt = jax_for_arch(jcfg, lr=1e-3), for_arch(cfg, lr=1e-3)
    assert topt.name == "adafactor"
    jstate, state, jl, tl, _ = _three_steps(ARCHS[1], jopt, topt, "bfloat16")
    for a, b in zip(tl, jl):
        assert abs(a - b) <= BF16_LOSS_RTOL * abs(b), (tl, jl)
    assert {t.dtype for t in jax.tree.leaves(state["params"])} == {torch.bfloat16}
    assert "f" in state["opt"]  # Adafactor's factored moments, fp32
    assert {t.dtype for t in jax.tree.leaves(state["opt"])} == {torch.float32}


@pytest.mark.parametrize("arch", ARCHS)
def test_train_state_checkpoint_keeps_the_jax_leaf_order(arch, tmp_path):
    from repro.checkpoint import CheckpointManager as JaxManager
    from repro.optim.optimizers import for_arch as jax_for_arch
    from repro.runtime import steps as JS
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_smoke_config
    from repro_torch.convert import train_state_from_numpy
    from repro_torch.pytree import leaves

    pdt = "bfloat16" if arch == "kimi_k2_1t_a32b" else "float32"
    cfg = dataclasses.replace(get_smoke_config(arch), param_dtype=pdt)
    jcfg = dataclasses.replace(_setup(arch)[0], param_dtype=pdt)
    jstate = jax.tree.map(np.asarray, JS.init_train_state(
        jcfg, jax_for_arch(jcfg), jax.random.PRNGKey(0)))
    state = train_state_from_numpy(cfg, jstate, device="cpu")
    ours, theirs = leaves(state), jax.tree.leaves(jstate)
    assert [tuple(t.shape) for t in ours] == [np.shape(w) for w in theirs]
    for t, w in zip(ours, theirs):  # JAX's numbering: the same leaf at each index
        np.testing.assert_array_equal(t.float().numpy(), np.asarray(w, np.float32))
    order = sorted(state["params"])
    assert order[0] == ("dense_layers" if cfg.first_dense else "embed")

    CheckpointManager(tmp_path).save(3, state)
    like = jax.tree.map(lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"), state)
    got, step = CheckpointManager(tmp_path).restore(like)
    assert step == 3
    for a, b in zip(leaves(got), ours):
        assert a.dtype == b.dtype and torch.equal(a, b)
    jgot, jstep = JaxManager(tmp_path).restore(jstate)
    assert jstep == 3
    for a, b in zip(jax.tree.leaves(jgot), theirs):  # a bf16 leaf reads as its uint16 bits
        a, b = np.asarray(a), np.asarray(b)
        if str(b.dtype) == "bfloat16":
            a, b = a.view(np.uint16), b.view(np.uint16)
        np.testing.assert_array_equal(a, b)
