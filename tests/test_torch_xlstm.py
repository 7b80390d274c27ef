"""Port parity: the xLSTM family (models/xlstm.py and the xlstm branches of
models/model.py, convert.py, launch/serve.py and training).

The mLSTM chunked form against JAX's and against the step-by-step
`mlstm_ref` (the JAX suite's 2e-3, tests/test_models.py); the mLSTM and
sLSTM blocks and their decode steps against JAX's; and for the xlstm_1p3b
smoke config (2 groups of one mLSTM and one sLSTM block, fp32 compute) the
JAX params crossing with `lm_params_from_numpy`, then forward, prefill
(logits and every cache leaf) and six teacher-forced decode steps held
against the JAX model at 1e-4.  Greedy prefill + decode must equal the
argmax of the teacher-forced forward.  Training: three SGD and AdamW
steps against JAX's jitted step, remat (each mLSTM block twice a step, the
sLSTM block once, as JAX's forward), train states crossing between the two
checkpoint managers bit for bit, and the runner's bit-for-bit replay after
faults.  The sLSTM recurrence runs through K3's plain version (CPU
tensors) and, under grad, its BPTT backward.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from test_torch_common import ZERO_GRAD_LEAVES, assert_close, rand, to_jax, to_torch

TOL = 1e-4
CHUNK_TOL = 2e-3  # tests/test_models.py::test_mlstm_chunked_vs_sequential
ARCH = "xlstm_1p3b"
B, P, G = 2, 12, 7  # batch, prompt, generated tokens (G - 1 = 6 decode steps)


def _X():
    from repro_torch.models import xlstm

    return xlstm


def _M():
    from repro_torch.models import model

    return model


def _to_torch_tree(tree):
    return {k: _to_torch_tree(v) if isinstance(v, dict) else to_torch(np.array(v))
            for k, v in tree.items()}


def _clone(tree):
    return {k: _clone(v) if isinstance(v, dict) else v.clone() for k, v in tree.items()}


@functools.lru_cache(maxsize=None)
def _setup():
    """(JAX cfg, JAX params, port cfg, port params, prompt tokens)."""
    import jax

    from repro.configs import get_smoke_config as jax_smoke
    from repro.models import model as JM
    from repro.models.layers import split_tree
    from repro_torch.configs import get_smoke_config
    from repro_torch.convert import lm_params_from_numpy

    jcfg = jax_smoke(ARCH)
    vals, _ = split_tree(JM.init(jcfg, jax.random.PRNGKey(0)))
    cfg = get_smoke_config(ARCH)
    params = lm_params_from_numpy(cfg, jax.tree.map(np.asarray, vals), device="cpu")
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (B, P)).astype(np.int32)
    return jcfg, vals, cfg, params, toks


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def test_configs_match_the_jax_ones():
    from repro.configs import get_config as jax_config
    from repro.configs import get_smoke_config as jax_smoke
    from repro_torch.configs import get_config, get_smoke_config

    for ours, theirs in ((get_config(ARCH), jax_config(ARCH)),
                         (get_smoke_config(ARCH), jax_smoke(ARCH))):
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
        assert ours.param_counts() == theirs.param_counts()
    full = get_config("xlstm-1.3b")
    assert full.cdtype == torch.bfloat16 and full.dtype == torch.float32
    assert (full.n_layers, full.d_model, full.n_heads, full.vocab) == (48, 2048, 4, 50304)
    assert _M().stack_sizes(full) == {"mlstm": 42, "slstm": 6}


@pytest.mark.parametrize("b,s,h,p,chunk", [(2, 48, 2, 16, 16), (1, 40, 3, 8, 16), (2, 32, 1, 8, 64)])
def test_mlstm_chunked_matches_jax_and_the_sequential_ref(b, s, h, p, chunk):
    from repro.models.xlstm import _mlstm_chunked as jax_chunked
    from repro.models.xlstm import mlstm_ref as jax_ref

    rng = np.random.default_rng(s + h)
    q, k, v = rand(rng, b, s, h, p), rand(rng, b, s, h, p), rand(rng, b, s, h, p)
    ig = rand(rng, b, s, h)
    fg = rand(rng, b, s, h) + 2.0
    got, (C, n, m) = _X()._mlstm_chunked(*(to_torch(a) for a in (q, k, v, ig, fg)), chunk)
    want, (jC, jn, jm) = jax_chunked(*(to_jax(a) for a in (q, k, v, ig, fg)), chunk)
    assert tuple(got.shape) == (b, s, h, p)
    assert_close(got, want, rtol=TOL, atol=TOL, what="h vs JAX")
    for name, a, c in (("C", C, jC), ("n", n, jn), ("m", m, jm)):
        assert_close(a, c, rtol=TOL, atol=TOL, what=f"final {name} vs JAX")
    port_ref = _X().mlstm_ref(*(to_torch(a) for a in (q, k, v, ig, fg)))
    assert_close(port_ref, jax_ref(*(to_jax(a) for a in (q, k, v, ig, fg))), rtol=TOL, atol=TOL,
                 what="mlstm_ref vs JAX")
    assert_close(got, port_ref, rtol=CHUNK_TOL, atol=CHUNK_TOL, what="chunked vs sequential")


def _jax_mixers(d, h, seed):
    import jax

    from repro.models.layers import split_tree
    from repro.models.xlstm import init_mlstm, init_slstm

    km, ks = jax.random.split(jax.random.PRNGKey(seed))
    pm, _ = split_tree(init_mlstm(km, d, h))
    ps, _ = split_tree(init_slstm(ks, d, h))
    return pm, ps


def test_mlstm_block_and_decode_match_jax():
    import jax

    from repro.models import xlstm as JX

    d, h, s = 32, 2, 24
    pm, _ = _jax_mixers(d, h, seed=3)
    x = rand(np.random.default_rng(4), B, s, d)
    xs = rand(np.random.default_rng(5), 4, B, 1, d)
    want, jcache = JX.mlstm_block(pm, to_jax(x), n_heads=h, chunk=8, return_cache=True)
    tpm = _to_torch_tree(pm)
    got, cache = _X().mlstm_block(tpm, to_torch(x), n_heads=h, chunk=8, return_cache=True)
    assert_close(got, want, rtol=TOL, atol=TOL, what="block out")
    for name in ("conv_buf", "C", "n", "m"):
        assert_close(cache[name], jcache[name], rtol=TOL, atol=TOL, what=f"cache {name}")
    step = jax.jit(functools.partial(JX.mlstm_decode, n_heads=h))
    cache = _clone(cache)
    for i in range(xs.shape[0]):
        jout, jcache = step(pm, to_jax(xs[i]), jcache)
        out, cache2 = _X().mlstm_decode(tpm, to_torch(xs[i]), cache, n_heads=h)
        assert cache2 is cache  # updated in place
        assert tuple(out.shape) == (B, 1, d)
        assert_close(out, jout, rtol=TOL, atol=TOL, what=f"decode {i}")
        for name in ("conv_buf", "C", "n", "m"):
            assert_close(cache[name], jcache[name], rtol=TOL, atol=TOL, what=f"decode {i} {name}")


def test_slstm_block_and_decode_match_jax():
    import jax

    from repro.models import xlstm as JX

    d, h, s = 32, 4, 20
    _, ps = _jax_mixers(d, h, seed=6)
    x = rand(np.random.default_rng(7), B, s, d)
    xs = rand(np.random.default_rng(8), 4, B, 1, d)
    want, jstate = JX.slstm_block(ps, to_jax(x), n_heads=h, return_cache=True)
    tps = _to_torch_tree(ps)
    got, state = _X().slstm_block(tps, to_torch(x), n_heads=h, return_cache=True)
    assert_close(got, want, rtol=TOL, atol=TOL, what="block out")
    assert_close(got, _X().slstm_block(tps, to_torch(x), n_heads=h), rtol=0, atol=0)
    for name in ("h", "c", "n", "m"):
        assert_close(state[name], jstate[name], rtol=TOL, atol=TOL, what=f"state {name}")
    step = jax.jit(functools.partial(JX.slstm_decode, n_heads=h))
    for i in range(xs.shape[0]):
        jout, jstate = step(ps, to_jax(xs[i]), jstate)
        out, state2 = _X().slstm_decode(tps, to_torch(xs[i]), state, n_heads=h)
        assert state2 is state
        assert_close(out, jout, rtol=TOL, atol=TOL, what=f"decode {i}")
        for name in ("h", "c", "n", "m"):
            assert_close(state[name], jstate[name], rtol=TOL, atol=TOL, what=f"decode {i} {name}")


def test_lm_params_from_numpy_takes_the_xlstm_tree():
    import jax

    _, vals, _, params, _ = _setup()
    flat_j = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
              for path, v in jax.tree_util.tree_flatten_with_path(vals)[0]}
    flat_t = _flat(params)
    assert set(flat_t) == set(flat_j)
    assert "slstm/mixer/r_f" in flat_t and "mlstm/mixer/wq" in flat_t
    for name, a in flat_j.items():
        t = flat_t[name]
        assert t.dtype == torch.float32 and t.device.type == "cpu"
        assert np.array_equal(t.numpy(), a), name


def test_init_has_the_jax_tree_and_shapes():
    import jax

    _, vals, cfg, _, _ = _setup()
    ours = _M().init(cfg, seed=0, device="cpu")
    flat_j = {"/".join(str(getattr(k, "key", k)) for k in path): np.shape(v)
              for path, v in jax.tree_util.tree_flatten_with_path(vals)[0]}
    flat_t = {k: tuple(v.shape) for k, v in _flat(ours).items()}
    assert flat_t == flat_j
    assert all(v.dtype == torch.float32 for v in _flat(ours).values())
    assert float(ours["slstm"]["mixer"]["b_f"].min()) == 3.0
    cast = _M().cast_params(cfg, ours)
    assert len(cast["mlstm"]) == 2 and len(cast["slstm"]) == 2
    assert _M().cast_params(cfg, cast) is cast


def test_forward_matches_jax():
    from repro.models import model as JM

    jcfg, vals, cfg, params, toks = _setup()
    want, _ = JM.forward(jcfg, vals, {"tokens": to_jax(toks)})
    got, aux = _M().forward(cfg, params, {"tokens": to_torch(toks)})
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, P, cfg.vocab)
    assert float(aux) == 0.0
    assert_close(got, want, rtol=TOL, atol=TOL)


@functools.lru_cache(maxsize=None)
def _jax_serve():
    """JAX prefill, then G - 1 greedy decode steps: (prefill logits, prefill
    cache, [(token fed, step logits)], final cache)."""
    import jax
    import jax.numpy as jnp

    from repro.launch.serve import _merge_prefill_cache as jax_merge
    from repro.models import model as JM

    jcfg, vals, _, _, toks = _setup()
    logits, pre = JM.prefill(jcfg, vals, {"tokens": to_jax(toks)})
    cache = jax_merge(jcfg, JM.init_cache(jcfg, B, P + G), pre)
    step = jax.jit(functools.partial(JM.decode_step, jcfg))
    tok = jnp.argmax(logits[:, -1, :], axis=-1).astype(jnp.int32)[:, None]
    steps = []
    for i in range(G - 1):
        lg, cache = step(vals, cache, tok, jnp.asarray(P + i, jnp.int32))
        steps.append((np.array(tok), lg))
        tok = jnp.argmax(lg[:, -1, :], axis=-1).astype(jnp.int32)[:, None]
    return logits, pre, steps, cache


def test_prefill_and_decode_steps_match_jax():
    from repro_torch.launch.serve import _merge_prefill_cache

    _, _, cfg, params, toks = _setup()
    jlogits, jpre, jsteps, jcache = _jax_serve()
    logits, pre = _M().prefill(cfg, params, {"tokens": to_torch(toks)})
    assert_close(logits, jlogits, rtol=TOL, atol=TOL, what="prefill logits")
    flat_j, flat_t = _flat(jpre), _flat(pre)
    assert set(flat_t) == set(flat_j) == {
        "mlstm/conv_buf", "mlstm/C", "mlstm/n", "mlstm/m",
        "slstm/h", "slstm/c", "slstm/n", "slstm/m"}
    for name, want in flat_j.items():
        assert tuple(flat_t[name].shape) == tuple(want.shape), name
        assert_close(flat_t[name], want, rtol=TOL, atol=TOL, what=f"prefill cache {name}")
    cache = _merge_prefill_cache(cfg, None, pre)
    assert cache is pre  # the state caches carry over as they are
    assert len(jsteps) == G - 1 == 6
    for i, (tok, jlg) in enumerate(jsteps):  # the JAX tokens, fed to both
        lg, cache = _M().decode_step(cfg, params, cache, to_torch(tok), P + i)
        assert tuple(lg.shape) == (B, 1, cfg.vocab)
        assert_close(lg, jlg, rtol=TOL, atol=TOL, what=f"decode step {i}")
    for name, want in _flat(jcache).items():
        assert_close(_flat(cache)[name], want, rtol=TOL, atol=TOL, what=f"final cache {name}")


def test_init_cache_matches_jax():
    from repro.models import model as JM

    jcfg, _, cfg, _, _ = _setup()
    want = _flat(JM.init_cache(jcfg, B, P + G))
    got = _flat(_M().init_cache(cfg, B, P + G, device="cpu"))
    assert set(got) == set(want)
    for name, w in want.items():
        assert tuple(got[name].shape) == tuple(w.shape), name
        assert np.array_equal(got[name].numpy(), np.asarray(w)), name


def test_short_prompt_leaves_older_conv_rows_zero():
    """A prompt shorter than the convolution's width - 1 fills the last
    rows of conv_buf; decoding from it equals decoding from the same prompt
    padded on the left with zero rows of u, i.e. the forward."""
    _, _, cfg, params, toks = _setup()
    M = _M()
    _, pre = M.prefill(cfg, params, {"tokens": to_torch(toks[:, :2])})
    assert torch.equal(pre["mlstm"]["conv_buf"][:, :, :, 0], torch.zeros_like(
        pre["mlstm"]["conv_buf"][:, :, :, 0]))
    lg, _ = M.decode_step(cfg, params, pre, to_torch(toks[:, 2:3]), 2)
    full, _ = M.forward(cfg, params, {"tokens": to_torch(toks[:, :3])})
    assert_close(lg[:, 0], full[:, 2], rtol=TOL, atol=TOL)


def test_greedy_decode_matches_teacher_forced_forward():
    _, _, cfg, params, toks = _setup()
    M = _M()
    logits, cache = M.prefill(cfg, params, {"tokens": to_torch(toks)})
    tok = torch.argmax(logits[:, -1, :], dim=-1)[:, None]
    gen = [tok]
    for i in range(G - 1):
        lg, cache = M.decode_step(cfg, params, cache, tok, P + i)
        tok = torch.argmax(lg[:, -1, :], dim=-1)[:, None]
        gen.append(tok)
    gen = torch.cat(gen, dim=1)
    full, _ = M.forward(cfg, params, {"tokens": torch.cat([to_torch(toks).long(), gen], dim=1)})
    greedy = torch.argmax(full[:, P - 1: P + G - 1, :], dim=-1)
    assert torch.equal(greedy, gen)


def test_xlstm_entry_points_default_to_the_card(monkeypatch):
    from repro_torch.configs import get_smoke_config

    cfg = get_smoke_config(ARCH)
    X, M = _X(), _M()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for entry in (lambda: M.init(cfg), lambda: M.init_cache(cfg, 1, 4),
                  lambda: X.init_mlstm_cache(1, 16, 2), lambda: X.init_slstm_cache(1, 16)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            entry()
    assert M.init_cache(cfg, 1, 4, device="cpu")["slstm"]["m"].device.type == "cpu"
    m = X.init_slstm_cache(1, 16, device="cpu")["m"]
    assert torch.equal(m, torch.full_like(m, -1e30))


# -- training (K3's forward with the plain BPTT backward) ----------------------

LOSS_RTOL, GRAD_TOL = 1e-5, 1e-4  # tests/test_torch_train.py's rules
ADAMW_TYPICAL, ADAMW_MAX = 1e-3, 0.5
# The sLSTM input-gate bias has an exact gradient of zero, so after SGD
# steps it holds only rounding on both sides: held to GRAD_TOL of its
# sibling's largest |value| (ZERO_GRAD_LEAVES).  AdamW maps that rounding
# (some 1e-9) to updates of up to ~0.1 lr on each side (m_hat / (sqrt(v_hat)
# + 1e-8)), of either sign: such a leaf is held to ADAMW_MAX alone.


def _named(tree) -> dict:
    import jax

    return {jax.tree_util.keystr(p): np.asarray(v, np.float32)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("which", ["sgd", "adamw"])
def test_three_train_steps_match_jax(which):
    """Three steps of the smoke config from one state, JAX's jitted step
    against the port's: losses within 1e-5 relative; SGD params within 1e-4
    of each leaf's largest |value|, AdamW's updates on the scale of lr."""
    import jax
    import jax.numpy as jnp

    from repro.optim import adamw as jadamw, sgd as jsgd
    from repro.runtime import steps as JS
    from repro_torch.convert import train_state_from_numpy, train_state_to_numpy
    from repro_torch.launch.train import make_batches
    from repro_torch.optim import adamw, sgd
    from repro_torch.runtime import steps

    jcfg, _, cfg, _, _ = _setup()
    lr = 0.5 if which == "sgd" else 1e-3
    jopt, topt = (jsgd(lr), sgd(lr)) if which == "sgd" else (jadamw(lr), adamw(lr))
    jstate = JS.init_train_state(jcfg, jopt, jax.random.PRNGKey(0))
    state = train_state_from_numpy(cfg, jax.tree.map(np.array, jstate), device="cpu")
    start = _named(jax.tree.map(np.array, jstate["params"]))
    jstep, step = jax.jit(JS.make_train_step(jcfg, jopt)), steps.make_train_step(cfg, topt)
    batches = make_batches(cfg, 4, 24, seed=0)
    for i in range(3):
        jstate, jm = jstep(jstate, {"tokens": jnp.asarray(batches(i)["tokens"])})
        state, m = step(state, batches(i))
        assert abs(float(m["loss"]) - float(jm["loss"])) <= LOSS_RTOL * abs(float(jm["loss"]))
    assert int(state["step"]) == int(jstate["step"]) == 3
    got, want = _named(train_state_to_numpy(state)["params"]), _named(jstate["params"])
    assert list(got) == list(want)
    for name, w in want.items():
        if which == "sgd":
            scale = max(float(np.abs(want[ZERO_GRAD_LEAVES.get(name, name)]).max()), 1e-30)
            np.testing.assert_allclose(got[name], w, rtol=0, atol=GRAD_TOL * scale,
                                       err_msg=name)
        else:  # the three updates, on the scale of lr
            d = np.abs((got[name] - start[name]) - (w - start[name]))
            assert float(d.max()) <= ADAMW_MAX * lr, (name, float(d.max()) / lr)
            if name not in ZERO_GRAD_LEAVES:
                assert float(np.mean(d > ADAMW_TYPICAL * lr)) <= 1e-3, name


def test_remat_reruns_the_mlstm_blocks_and_not_the_slstm_block(monkeypatch):
    """As JAX's forward: with cfg.remat each mLSTM block runs twice a step
    (forward and the backward's recompute) and each sLSTM block once, so
    K3 (SlstmSeq's forward) runs once an sLSTM block; without remat every
    block once; the gradients agree."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels.slstm_step import ops
    from repro_torch.pytree import leaves

    X, M = _X(), _M()
    calls = {"slstm": 0, "mlstm": 0}
    real_seq, real_mlstm = ops.SlstmSeq.forward, X.mlstm_block

    def seq(ctx, *a):
        calls["slstm"] += 1
        return real_seq(ctx, *a)

    def mlstm(*a, **kw):
        calls["mlstm"] += 1
        return real_mlstm(*a, **kw)

    monkeypatch.setattr(ops.SlstmSeq, "forward", staticmethod(seq))
    monkeypatch.setattr(X, "mlstm_block", mlstm)
    grads = {}
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, 256, (2, 16)))
    for remat in (True, False):
        cfg = dataclasses.replace(get_smoke_config(ARCH), remat=remat)
        params = M.init(cfg, 0, "cpu")
        flat = leaves(params)
        for p in flat:
            p.requires_grad_(True)
        calls.update(slstm=0, mlstm=0)
        loss, _ = M.loss_fn(cfg, params, {"tokens": toks})
        grads[remat] = torch.autograd.grad(loss, flat)
        n_groups = cfg.n_layers // cfg.slstm_every
        assert calls == {"slstm": n_groups,
                         "mlstm": (2 if remat else 1) * n_groups * (cfg.slstm_every - 1)}
    for a, b in zip(grads[True], grads[False]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_train_state_checkpoints_cross_between_the_packages(tmp_path):
    """A state the port saves restores in JAX, and one JAX saves restores in
    the port, bit for bit, leaf i the same leaf on both sides ("mlstm" and
    "slstm" stacks, AdamW's moments), as `abstract_train_state` lays it."""
    import jax

    from repro.checkpoint import CheckpointManager as JaxManager
    from repro.optim.optimizers import for_arch as jax_for_arch
    from repro.runtime import steps as JS
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.convert import train_state_from_numpy, train_state_to_numpy
    from repro_torch.optim import for_arch
    from repro_torch.pytree import leaves
    from repro_torch.runtime import steps

    jcfg, _, cfg, _, _ = _setup()
    assert for_arch(cfg).name == jax_for_arch(jcfg).name
    jstate = jax.tree.map(np.asarray, JS.init_train_state(jcfg, jax_for_arch(jcfg),
                                                          jax.random.PRNGKey(0)))
    state = train_state_from_numpy(cfg, jstate, device="cpu")
    ours, theirs = leaves(state), jax.tree.leaves(jstate)
    assert [tuple(t.shape) for t in ours] == [np.shape(w) for w in theirs]
    like = steps.abstract_train_state(cfg, for_arch(cfg))
    assert [tuple(t.shape) for t in leaves(like)] == [tuple(t.shape) for t in ours]
    for a, b in zip(jax.tree.leaves(train_state_to_numpy(state)), theirs):
        np.testing.assert_array_equal(a, b)

    CheckpointManager(tmp_path / "port").save(3, state)
    jgot, jstep = JaxManager(tmp_path / "port").restore(jstate)
    assert jstep == 3
    for a, b in zip(jax.tree.leaves(jgot), theirs):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    bumped = jax.tree.map(lambda a: a + 1 if a.dtype == np.float32 else a, jstate)
    JaxManager(tmp_path / "jax").save(5, bumped)
    got, step = CheckpointManager(tmp_path / "jax").restore(like, device="cpu")
    assert step == 5
    for a, b in zip(leaves(got), jax.tree.leaves(bumped)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_runner_fault_recovery_replays_bit_for_bit(tmp_path):
    """TrainRunner on the smoke config: faults at steps 5 and 6 restore step
    4 and replay; every replayed loss and the final state equal the
    uninterrupted run's bit for bit."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.train import make_batches
    from repro_torch.optim import adamw
    from repro_torch.pytree import leaves
    from repro_torch.runtime.runner import RunnerConfig, TrainRunner

    cfg = get_smoke_config(ARCH)
    batches = make_batches(cfg, 2, 16)

    def runner(name, hook=None):
        return TrainRunner(cfg, (1, 1), adamw(1e-3), RunnerConfig(str(tmp_path / name),
                                                                  ckpt_every=4),
                           device="cpu", fault_hook=hook)

    s1, h1 = runner("clean").run(batches, 8)
    fail_at = {5: True, 6: True}

    def hook(step):
        if fail_at.pop(step, False):
            raise RuntimeError(f"injected failure at {step}")

    r2 = runner("faulty", hook)
    s2, h2 = r2.run(batches, 8)
    assert [e["step"] for e in r2.events if e["kind"] == "restore"] == [4, 4]
    # history: 0-4, replay 4-5, replay 4-7; every replayed step is the first pass's
    losses1, losses2 = [h["loss"] for h in h1], [h["loss"] for h in h2]
    assert losses2 == losses1[:5] + losses1[4:6] + losses1[4:]
    assert all(torch.equal(a, b) for a, b in zip(leaves(s1), leaves(s2)))
