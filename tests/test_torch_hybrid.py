"""Port parity: the hybrid (Mamba2) family, zamba2 (configs, the hybrid
branches of models/model.py, convert, launch/serve and launch/train)
against the JAX package.

For zamba2_1p2b's SMOKE config (2 groups of 2 Mamba2 blocks, each followed
by the weight-tied shared block; fp32 compute) and SMOKE cut to 5 layers
(2 groups and a 1-block "mamba_tail"), JAX's params (`M.init`,
numpy-mapped) cross with `convert.lm_params_from_numpy`, and the port is
held against JAX at 1e-4:
  * CONFIG and SMOKE equal JAX's (fields and parameter counts); `init`
    gives JAX's tree and shapes ("shared_attn" one block with no layer
    axis); `cut_depth` keeps whole groups and a tail, and refuses a depth
    below attn_every;
  * forward (the shared block's attention at impl "pallas", the TPU kernel
    in interpret mode, and "blockwise"), prefill (logits and every cache
    leaf: "mamba" conv_buf and S, "attn" K/V per application,
    "mamba_tail") and teacher-forced decode steps with the final cache;
  * loss_fn and every gradient leaf (1e-4 of its leaf's largest |value|),
    remat on and off; with remat the shared block's attention runs twice
    an application (forward and recompute) and its gradient sums the
    applications;
  * the serve CLI's greedy tokens are those of JAX's model-level loop
    (prefill, JAX's `_merge_prefill_cache`, its jitted decode step);
  * three SGD and AdamW train steps against JAX's jitted step, the train
    CLI with a fault and replay, and train states crossing between the
    two checkpoint managers bit for bit.
The K2 calls run its plain version (CPU tensors); on the card a `gpu`
test holds every K2 launch of a bf16 prefill against the plain version on
that launch's inputs.
"""

import dataclasses
import functools
import re

import numpy as np
import pytest
import torch

from test_torch_common import assert_bf16_close, assert_close, require_cuda, to_jax, to_torch

TOL, LOSS_RTOL, GRAD_TOL = 1e-4, 1e-5, 1e-4
ARCH = "zamba2_1p2b"
DEPTHS = [4, 5]  # SMOKE (2 groups of 2), and 2 groups + a 1-block tail
B, P, G = 2, 12, 7  # batch, prompt, generated tokens (G - 1 = 6 decode steps)
# A step's AdamW update against JAX's, in units of lr (test_torch_train.py's rule).
ADAMW_TYPICAL, ADAMW_MAX = 1e-3, 0.5


@functools.lru_cache(maxsize=None)
def _setup(n_layers):
    """(JAX cfg, JAX params, port cfg, port params, prompt tokens)."""
    import jax

    from repro.configs import get_smoke_config as jax_smoke
    from repro.models import model as JM
    from repro.models.layers import split_tree
    from repro_torch.configs import get_smoke_config
    from repro_torch.convert import lm_params_from_numpy

    jcfg = dataclasses.replace(jax_smoke(ARCH), n_layers=n_layers)
    cfg = dataclasses.replace(get_smoke_config(ARCH), n_layers=n_layers)
    vals, _ = split_tree(JM.init(jcfg, jax.random.PRNGKey(0)))
    params = lm_params_from_numpy(cfg, jax.tree.map(np.asarray, vals), device="cpu")
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (B, P)).astype(np.int32)
    return jcfg, vals, cfg, params, toks


def _M():
    from repro_torch.models import model

    return model


def _shapes(tree) -> dict:
    import jax

    return {jax.tree_util.keystr(p): tuple(np.shape(v))
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _jax_cache(jcfg, pre, length):
    """JAX's prefill cache merged into one of `length` positions, as JAX's
    serve loop merges it."""
    from repro.launch.serve import _merge_prefill_cache as jax_merge
    from repro.models import model as JM

    return jax_merge(jcfg, JM.init_cache(jcfg, B, length), pre)


def _cache_leaves(cache) -> dict:
    return {f"{stack}/{name}": t for stack, d in cache.items() for name, t in d.items()}


def test_configs_match_the_jax_ones():
    from repro.configs import get_config as jax_config
    from repro.configs import get_smoke_config as jax_smoke
    from repro_torch.configs import get_config, get_smoke_config

    for ours, theirs in ((get_config(ARCH), jax_config(ARCH)),
                         (get_smoke_config(ARCH), jax_smoke(ARCH))):
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
        assert ours.param_counts() == theirs.param_counts()
    full = get_config("zamba2-1.2b")
    assert full.family == "hybrid" and full.cdtype == torch.bfloat16
    assert full.dtype == torch.float32 and full.resolved_head_dim == 64
    assert _M().stack_sizes(full) == {"mamba": 36, "mamba_tail": 2}
    assert full.param_counts() == {"total": 1_104_693_376, "active": 1_440_237_696}


def test_cut_depth_keeps_groups_and_a_tail():
    from repro_torch.configs import cut_depth, get_config, get_smoke_config

    full = get_config(ARCH)
    for n, sizes in ((14, {"mamba": 12, "mamba_tail": 2}), (6, {"mamba": 6}),
                     (8, {"mamba": 6, "mamba_tail": 2}), (38, {"mamba": 36, "mamba_tail": 2})):
        cut = cut_depth(full, n)
        assert cut.n_layers == n and cut.d_model == full.d_model
        assert _M().stack_sizes(cut) == sizes
    for bad in (1, 5, 39):
        with pytest.raises(ValueError, match="--n-layers"):
            cut_depth(full, bad)
    with pytest.raises(ValueError, match="--n-layers"):
        cut_depth(get_smoke_config(ARCH), 1)  # attn_every 2
    with pytest.raises(ValueError, match="one group"):
        _M().init(dataclasses.replace(get_smoke_config(ARCH), n_layers=1), device="cpu")


@pytest.mark.parametrize("n_layers", DEPTHS)
def test_init_and_conversion_give_the_jax_tree(n_layers):
    import jax

    _, vals, cfg, params, _ = _setup(n_layers)
    ours = _M().init(cfg, seed=0, device="cpu")
    for tree in (ours, params):
        assert _shapes(tree) == _shapes(vals)
        assert {t.dtype for t in jax.tree.leaves(tree)} == {torch.float32}
    assert set(vals) == {"embed", "mamba", "shared_attn", "final_norm"} | (
        {"mamba_tail"} if n_layers == 5 else set())
    assert ours["shared_attn"]["attn"]["wq"].shape == (cfg.d_model, cfg.n_heads, 16)
    np.testing.assert_allclose(ours["mamba"]["mixer"]["A_log"].numpy(),  # an fp32 ulp
                               np.asarray(vals["mamba"]["mixer"]["A_log"]), rtol=2e-7, atol=0)
    for got, w in zip(jax.tree.leaves(params), jax.tree.leaves(vals)):  # JAX's values
        np.testing.assert_array_equal(got.numpy(), np.asarray(w))


@pytest.mark.parametrize("n_layers", DEPTHS)
@pytest.mark.parametrize("impl", ["pallas", "blockwise"])
def test_forward_matches_jax(n_layers, impl):
    from repro.models import model as JM

    jcfg, vals, cfg, params, toks = _setup(n_layers)
    want, want_aux = JM.forward(dataclasses.replace(jcfg, attn_impl=impl), vals,
                                {"tokens": to_jax(toks)})
    got, aux = _M().forward(dataclasses.replace(cfg, attn_impl=impl), params,
                            {"tokens": to_torch(toks)})
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, P, cfg.vocab)
    assert float(aux) == float(want_aux) == 0.0
    assert_close(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("n_layers", DEPTHS)
def test_prefill_and_decode_steps_match_jax(n_layers):
    """Prefill logits and every cache leaf, then six decode steps fed JAX's
    greedy tokens, and the final cache; the port's greedy tokens over the
    steps equal the argmax of its teacher-forced forward."""
    import jax
    import jax.numpy as jnp

    from repro.models import model as JM
    from repro_torch.launch.serve import _merge_prefill_cache

    jcfg, vals, cfg, params, toks = _setup(n_layers)
    jlogits, jpre = JM.prefill(jcfg, vals, {"tokens": to_jax(toks)})
    logits, pre = _M().prefill(cfg, params, {"tokens": to_torch(toks)})
    assert_close(logits, jlogits, rtol=TOL, atol=TOL, what="prefill logits")
    n_groups = n_layers // cfg.attn_every
    ours, theirs = _cache_leaves(pre), _cache_leaves(jpre)
    assert set(ours) == set(theirs)
    assert tuple(ours["attn/k"].shape) == (n_groups, B, P, cfg.n_kv_heads, 16)
    assert tuple(ours["mamba/conv_buf"].shape) == (n_groups, 2, B, 3, 2 * 64 + 2 * 8)
    assert tuple(ours["mamba/S"].shape) == (n_groups, 2, B, 8, 8, 16)
    assert ("mamba_tail/S" in ours) == (n_layers == 5)
    for name, t in ours.items():
        assert t.dtype == torch.float32, name
        assert_close(t, theirs[name], rtol=TOL, atol=TOL, what=f"prefill cache {name}")

    jcache = _jax_cache(jcfg, jpre, P + G)
    cache = _merge_prefill_cache(cfg, _M().init_cache(cfg, B, P + G, device="cpu"), pre)
    assert cache["mamba"] is pre["mamba"]  # the state carried over as it is
    step = jax.jit(functools.partial(JM.decode_step, jcfg))
    tok = jnp.argmax(jlogits[:, -1, :], axis=-1).astype(jnp.int32)[:, None]
    fed = []
    for i in range(G - 1):  # JAX's greedy tokens, fed to both
        jlg, jcache = step(vals, jcache, tok, jnp.asarray(P + i, jnp.int32))
        lg, cache = _M().decode_step(cfg, params, cache, to_torch(np.asarray(tok)), P + i)
        assert tuple(lg.shape) == (B, 1, cfg.vocab)
        assert_close(lg, jlg, rtol=TOL, atol=TOL, what=f"decode step {i}")
        fed.append(np.asarray(tok))
        tok = jnp.argmax(jlg[:, -1, :], axis=-1).astype(jnp.int32)[:, None]
    theirs = _cache_leaves(jcache)
    for name, t in _cache_leaves(cache).items():
        assert_close(t, theirs[name], rtol=TOL, atol=TOL, what=f"final cache {name}")
    seq = torch.cat([to_torch(toks)] + [to_torch(t) for t in fed] + [to_torch(np.asarray(tok))],
                    dim=1).long()
    full, _ = _M().forward(cfg, params, {"tokens": seq})
    assert torch.equal(torch.argmax(full[:, P - 1:-1, :], dim=-1), seq[:, P:])


def test_short_prompt_leaves_the_older_conv_rows_zero():
    """A prompt of 2 tokens: each block's conv_buf holds its 2 raw rows last
    and a zero row first, and decoding from there matches the forward."""
    _, _, cfg, params, toks = _setup(5)
    seq = to_torch(toks[:, :5]).long()
    _, pre = _M().prefill(cfg, params, {"tokens": seq[:, :2]})
    for stack in ("mamba", "mamba_tail"):
        buf = pre[stack]["conv_buf"]
        assert bool((buf[..., 0, :] == 0).all()) and bool((buf[..., 1:, :] != 0).any())
    from repro_torch.launch.serve import _merge_prefill_cache

    cache = _merge_prefill_cache(cfg, _M().init_cache(cfg, B, 5, device="cpu"), pre)
    full, _ = _M().forward(cfg, params, {"tokens": seq})
    for i in range(2, 5):
        lg, cache = _M().decode_step(cfg, params, cache, seq[:, i:i + 1], i)
        assert_close(lg[:, 0], full[:, i], rtol=TOL, atol=TOL, what=f"position {i}")


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("n_layers", DEPTHS)
def test_loss_and_gradient_match_jax(n_layers, remat, monkeypatch):
    import jax

    from repro.models import model as JM
    from repro_torch.models import attention
    from repro_torch.pytree import leaves, unflatten

    jcfg, vals, cfg, params, _ = _setup(n_layers)
    jcfg, cfg = (dataclasses.replace(c, remat=remat) for c in (jcfg, cfg))
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (B, 16)).astype(np.int32)
    (jl, jm), jg = jax.value_and_grad(lambda p: JM.loss_fn(jcfg, p, {"tokens": toks}),
                                      has_aux=True)(vals)
    calls = []
    real = attention.ops.flash_attention

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(attention.ops, "flash_attention", counted)
    flat = [t.clone().requires_grad_(True) for t in leaves(params)]
    loss, metrics = _M().loss_fn(cfg, unflatten(params, flat), {"tokens": torch.from_numpy(toks)})
    grads = torch.autograd.grad(loss, flat)
    n_groups = n_layers // cfg.attn_every
    assert len(calls) == (2 if remat else 1) * n_groups  # remat: forward and recompute
    for got, want in ((loss.detach(), jl), (metrics["ce"].detach(), jm["ce"])):
        assert abs(float(got) - float(want)) <= LOSS_RTOL * abs(float(want))
    jflat = jax.tree.leaves(jg)
    assert len(jflat) == len(grads)
    for g, w in zip(grads, jflat):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=GRAD_TOL * max(float(np.abs(w).max()), 1e-30))
    wq = params["shared_attn"]["attn"]["wq"]
    shared = next(i for i, t in enumerate(leaves(params)) if t is wq)
    assert float(grads[shared].abs().max()) > 0


def test_shared_block_gradient_sums_its_applications():
    """The tied block's gradient is the sum of what each application alone
    gives: the same loss with the block's tensors split into one copy per
    application (each a leaf of its own) gives per-application gradients
    summing to the tied one."""
    from repro_torch.models import model as M
    from repro_torch.pytree import leaves, tree_map

    _, _, cfg, params, _ = _setup(4)
    toks = torch.from_numpy(np.random.default_rng(4).integers(0, cfg.vocab, (B, 16)))
    tied = tree_map(lambda t: t.clone().requires_grad_(True), params["shared_attn"])
    loss, _ = M.loss_fn(cfg, {**params, "shared_attn": tied}, {"tokens": toks})
    g_tied = torch.autograd.grad(loss, leaves(tied))

    copies = [tree_map(lambda t: t.clone().requires_grad_(True), params["shared_attn"])
              for _ in range(2)]
    real = M._hybrid_layers

    def split(cfg_, p):
        for kind, at, lp in real(cfg_, p):
            yield kind, at, copies[at[0]] if kind == "attn" else lp

    orig, M._hybrid_layers = M._hybrid_layers, split
    try:
        loss2, _ = M.loss_fn(cfg, params, {"tokens": toks})
    finally:
        M._hybrid_layers = orig
    g0, g1 = (torch.autograd.grad(loss2, leaves(c), retain_graph=True) for c in copies)
    assert loss2.item() == loss.item()
    for t, a, b in zip(g_tied, g0, g1):
        assert float(a.abs().max()) > 0 and float(b.abs().max()) > 0
        assert_close(t, a + b, rtol=1e-5, atol=1e-6)


def test_serve_cli_gives_the_tokens_of_the_jax_loop(monkeypatch, capsys):
    """--arch zamba2_1p2b --device cpu, its weights JAX's: the tokens are
    those of JAX's model-level serving loop on the same prompts (not JAX's
    CLI, which fails under this container's jax), and the prompt's K/V heads
    each application's cache."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_smoke_config as jax_smoke
    from repro.models import model as JM
    from repro.models.layers import split_tree
    from repro.runtime import steps as JS
    from repro_torch.convert import lm_params_from_numpy
    from repro_torch.launch import serve

    b, p, gen = 2, 10, 6
    jcfg = jax_smoke(ARCH)
    vals, _ = split_tree(JM.init(jcfg, jax.random.PRNGKey(0)))
    monkeypatch.setattr(serve.M, "init", lambda cfg, seed, device: lm_params_from_numpy(
        cfg, jax.tree.map(np.asarray, vals), device=device))
    run = serve.run(serve.parse_args(["--arch", ARCH, "--batch", str(b), "--prompt-len", str(p),
                                      "--gen", str(gen), "--device", "cpu", "--json"]))
    assert "generated token ids" in capsys.readouterr().out

    prompts = jnp.asarray(np.random.default_rng(0).integers(0, jcfg.vocab, (b, p)), jnp.int32)
    np.testing.assert_array_equal(run["prompts"].numpy(), np.asarray(prompts))
    logits, pre = JM.prefill(jcfg, vals, {"tokens": prompts})
    from repro.launch.serve import _merge_prefill_cache as jax_merge
    cache = jax_merge(jcfg, JM.init_cache(jcfg, b, p + gen), pre)
    step = jax.jit(JS.make_decode_step(jcfg))
    tok = jnp.argmax(logits[:, -1, :], axis=-1).astype(jnp.int32)[:, None]
    want = [tok]
    for i in range(gen - 1):
        nxt, cache = step(vals, cache, tok, jnp.asarray(p + i, jnp.int32))
        tok = nxt[:, None]
        want.append(tok)
    np.testing.assert_array_equal(run["tokens"].numpy(), np.asarray(jnp.concatenate(want, 1)))
    assert set(run["cache"]) == set(cache) == {"mamba", "attn"}
    for name, full in run["cache"]["attn"].items():
        assert full.shape[2] == p + gen
        assert torch.equal(full[:, :, :p], run["prefill_cache"]["attn"][name])


def _three_steps(jopt, topt):
    """Three steps of JAX's jitted train step and the port's at SMOKE with a
    tail, each from the state JAX's step before left (the port's copy
    converted afresh): a step's parity, not a trajectory's, since a one-ulp
    change of the initial params moves JAX's own params after three SGD
    steps at lr 0.5 by up to 5.8e-4 of a leaf's largest |value| (the
    zero-initialised conv_b and dt_bias hold only their summed, cancelling
    gradients).  [(params before, JAX state after, port state after, JAX
    loss, port loss)] a step."""
    import jax
    import jax.numpy as jnp

    from repro.runtime import steps as JS
    from repro_torch.convert import train_state_from_numpy
    from repro_torch.launch.train import make_batches
    from repro_torch.runtime import steps

    jcfg, _, cfg, _, _ = _setup(5)
    jstate = JS.init_train_state(jcfg, jopt, jax.random.PRNGKey(0))
    jstep, step = jax.jit(JS.make_train_step(jcfg, jopt)), steps.make_train_step(cfg, topt)
    batches = make_batches(cfg, 4, 24, seed=0)
    out = []
    for i in range(3):
        # copies: JAX may alias the numpy buffers, and the port updates in place
        host = jax.tree.map(np.array, jstate)
        state = train_state_from_numpy(cfg, jax.tree.map(np.array, host), device="cpu")
        before = [np.asarray(x, np.float32) for x in jax.tree.leaves(host["params"])]
        jstate, jm = jstep(jstate, {"tokens": jnp.asarray(batches(i)["tokens"])})
        state, m = step(state, batches(i))
        out.append((before, jstate, state, float(jm["loss"]), float(m["loss"])))
    return out


@pytest.mark.parametrize("which", ["sgd", "adamw"])
def test_three_train_steps_match_jax(which):
    import jax

    from repro.optim import adamw as jadamw, sgd as jsgd
    from repro_torch.convert import train_state_to_numpy
    from repro_torch.optim import adamw, sgd

    lr = 0.5 if which == "sgd" else 1e-3
    jopt, topt = (jsgd(lr), sgd(lr)) if which == "sgd" else (jadamw(lr), adamw(lr))
    runs = _three_steps(jopt, topt)
    for before, jstate, state, jl, tl in runs:
        assert abs(tl - jl) <= LOSS_RTOL * abs(jl), (tl, jl)
        back = train_state_to_numpy(state)
        for got, want, start in zip(jax.tree.leaves(back["params"]),
                                    jax.tree.leaves(jstate["params"]), before):
            want = np.asarray(want)
            if which == "sgd":
                scale = max(float(np.abs(want).max()), 1e-30)
                np.testing.assert_allclose(got, want, rtol=0, atol=GRAD_TOL * scale)
            else:
                d = np.abs((got - start) - (want - start))
                assert float(d.max()) <= ADAMW_MAX * lr, float(d.max()) / lr
                assert float(np.mean(d > ADAMW_TYPICAL * lr)) <= 1e-3
    assert [int(r[2]["step"]) for r in runs] == [1, 2, 3]


def test_train_state_checkpoints_cross_between_the_packages(tmp_path):
    """A state the port saves restores in JAX, and one JAX saves restores in
    the port, bit for bit, leaf i the same leaf on both sides ("mamba",
    "mamba_tail", the unstacked "shared_attn")."""
    import jax

    from repro.checkpoint import CheckpointManager as JaxManager
    from repro.optim.optimizers import for_arch as jax_for_arch
    from repro.runtime import steps as JS
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.convert import train_state_from_numpy
    from repro_torch.optim import for_arch
    from repro_torch.pytree import leaves
    from repro_torch.runtime import steps

    jcfg, _, cfg, _, _ = _setup(5)
    jstate = jax.tree.map(np.asarray, JS.init_train_state(jcfg, jax_for_arch(jcfg),
                                                          jax.random.PRNGKey(0)))
    state = train_state_from_numpy(cfg, jstate, device="cpu")
    ours, theirs = leaves(state), jax.tree.leaves(jstate)
    assert [tuple(t.shape) for t in ours] == [np.shape(w) for w in theirs]
    like = steps.abstract_train_state(cfg, for_arch(cfg))
    assert [tuple(t.shape) for t in leaves(like)] == [tuple(t.shape) for t in ours]

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


def test_cli_trains_with_a_fault_and_replay_on_cpu(tmp_path, capsys):
    """The smoke config cut to 3 layers (1 group and a 1-block tail) through
    the training CLI: a fault at 5 restored from 4, the first replayed loss
    exactly the first pass's, checkpoints at 4 and 8, the rescale reload."""
    from repro_torch.launch import train

    out = train.run(train.parse_args([
        "--arch", ARCH, "--n-layers", "3", "--device", "cpu", "--steps", "8", "--batch", "2",
        "--seq", "24", "--ckpt-every", "4", "--inject-fault-at", "5", "--rescale-mesh", "1x1",
        "--ckpt-dir", str(tmp_path / "ck")]))
    assert "(1 faults recovered)" in capsys.readouterr().out
    assert [s for s, _ in out["losses"]] == list(range(5)) + list(range(4, 8))
    assert out["losses"][5][1] == dict(out["losses"][:5])[4]  # the first replayed step
    assert out["ckpt_steps"] == [4, 8] and out["rescaled_step"] == 8
    assert out["cfg"].n_layers == 3
    for m in out["history"]:
        assert np.isfinite(m["loss"]) and m["moe_aux"] == 0.0 and m["n_tokens"] == 2 * 23


def test_cli_main_prints_the_step_time(tmp_path, capsys):
    """The training CLI's entry point prints, after the JAX CLI's lines, the
    median step time after the first step (no peak memory on the CPU)."""
    from repro_torch.launch import train

    out = train.main(["--arch", ARCH, "--n-layers", "3", "--device", "cpu", "--steps", "3",
                      "--batch", "2", "--seq", "24", "--ckpt-every", "3",
                      "--ckpt-dir", str(tmp_path / "ck")])
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert re.fullmatch(r"zamba2-1\.2b, 3 layers, 2 x 24 positions: step [0-9.]+ ms \(median "
                        r"of the 2 steps run after the first; first [0-9.]+ ms\)", last), last
    assert out["faults"] == 0 and out["ckpt_steps"] == [3]


@pytest.mark.gpu
def test_prefill_on_the_card_runs_every_application_through_k2():
    """The SMOKE config in bf16 compute on the card: one K2 launch per
    application of the shared block, each within the bf16 rule of the
    plain version on that launch's inputs, logits finite."""
    require_cuda()
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels.flash_attention import ops, ref
    from repro_torch.models import attention

    cfg = dataclasses.replace(get_smoke_config(ARCH), n_layers=5, compute_dtype="bfloat16")
    params = _M().cast_params(cfg, _M().init(cfg, seed=0, device="cuda"))
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (B, P))
    real, seen = ops.flash_attention, []

    def checked(q, k, v, *, causal=True, scale=None):
        out = real(q, k, v, causal=causal, scale=scale)
        seen.append((out, ref.attention_ref(q, k, v, causal=causal, scale=scale)))
        return out

    checked.launches = 0  # the launches count on the patched name while patched
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(attention.ops, "flash_attention", checked)
        logits, _ = _M().prefill(cfg, params, {"tokens": to_torch(toks).cuda()})
    torch.cuda.synchronize()
    assert checked.launches == len(seen) == 2
    for out, want in seen:
        assert_bf16_close(out, want)
    assert bool(torch.isfinite(logits).all())
