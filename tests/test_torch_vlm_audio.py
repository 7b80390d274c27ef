"""Port parity: the VLM family (phi3_vision_4p2b) and the audio-encoder
family (hubert_xlarge) against the JAX package on the CPU.

The smoke configs compute in fp32; JAX's params (`M.init`, numpy-mapped)
cross with `convert.lm_params_from_numpy` or `train_state_from_numpy`.
  * CONFIG and SMOKE equal JAX's (fields and parameter counts); `init`
    gives JAX's tree and shapes ("projector"; "frame_proj" and an untied
    "head" in place of "embed");
  * `audio_batches`, `vlm_batches` and launch/train.make_batches bit for
    bit;
  * hubert's prefill encodes: the forward's logits, no cache, K2 called
    non-causal in every layer; it has no decode step or cache;
  * the VLM serve loop: JAX's CLI sizes its cache prompt + gen, which
    clamps the last n_img decode writes into its last slot and moves the
    logits (the port's cache holds n_img + prompt + gen, held against JAX's
    model-level loop in tests/test_torch_lm_model.py); the port's serve CLI
    draws JAX's prompts and image embeddings and its tokens are greedy over
    the teacher-forced forward;
  * three train steps against JAX's jitted step (SGD params within 1e-4 of
    each leaf's largest |value|, losses within 1e-5 relative; AdamW losses
    within 1e-5 and the updates on the scale of lr);
  * train-state checkpoints crossing between the packages both ways, in
    JAX's leaf order;
  * the training CLI for both families, with a fault, the replay and the
    rescale reload.
Forward, prefill, decode, loss and gradients of both families (remat on
and off) are in tests/test_torch_lm_model.py and tests/test_torch_train.py.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import assert_close, to_jax, to_torch

TOL, LOSS_RTOL, GRAD_TOL = 1e-4, 1e-5, 1e-4
ARCHS = ["phi3_vision_4p2b", "hubert_xlarge"]
# AdamW's updates after three steps, in units of lr (test_torch_train.py's rule).
ADAMW_TYPICAL, ADAMW_MAX = 1e-3, 0.5
B, S = 2, 24  # vlm: 8 image positions and 16 text tokens


@functools.lru_cache(maxsize=None)
def _setup(arch):
    """(JAX cfg, JAX params, port cfg, port params)."""
    from repro.configs import get_smoke_config as jax_smoke
    from repro.models import model as JM
    from repro.models.layers import split_tree
    from repro_torch.configs import get_smoke_config
    from repro_torch.convert import lm_params_from_numpy

    jcfg, cfg = jax_smoke(arch), get_smoke_config(arch)
    vals, _ = split_tree(JM.init(jcfg, jax.random.PRNGKey(0)))
    return jcfg, vals, cfg, lm_params_from_numpy(cfg, jax.tree.map(np.asarray, vals), "cpu")


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
    full = get_config({"phi3_vision_4p2b": "phi-3-vision-4.2b",
                       "hubert_xlarge": "hubert-xlarge"}[arch])  # the CLI alias
    assert full.cdtype == torch.bfloat16 and full.dtype == torch.float32
    if arch == "phi3_vision_4p2b":
        assert full.family == "vlm" and full.resolved_head_dim == 96 and full.causal
        assert full.n_img_tokens == 576 and full.tie_embeddings
    else:
        assert full.family == "audio" and full.resolved_head_dim == 80 and not full.causal
        assert not full.tie_embeddings and not full.decode_supported


@pytest.mark.parametrize("arch", ARCHS)
def test_init_and_conversion_give_the_jax_tree(arch):
    _, vals, cfg, params = _setup(arch)
    for tree in (_M().init(cfg, seed=0, device="cpu"), params):
        assert _shapes(tree) == _shapes(vals)
        assert {t.dtype for t in jax.tree.leaves(tree)} == {torch.float32}
    top = set(vals)
    if arch == "hubert_xlarge":
        assert {"frame_proj", "head"} <= top and "embed" not in top
    else:
        assert {"embed", "projector"} <= top and "head" not in top
    for got, w in zip(jax.tree.leaves(params), jax.tree.leaves(vals)):  # JAX's values
        np.testing.assert_array_equal(got.numpy(), np.asarray(w, np.float32))


@pytest.mark.parametrize("family", ["audio", "vlm"])
def test_batches_are_the_jax_batches_bit_for_bit(family):
    from repro.configs import get_smoke_config as jax_smoke
    from repro.data import synthetic as jd
    from repro.launch.train import make_batches as jax_make_batches
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import synthetic as td
    from repro_torch.launch.train import make_batches

    if family == "audio":
        pairs = zip(jd.audio_batches(16, 32, 3, 20, 2, seed=5),
                    td.audio_batches(16, 32, 3, 20, 2, seed=5))
        arch = "hubert_xlarge"
    else:
        pairs = zip(jd.vlm_batches(256, 8, 32, 3, 12, 2, seed=5),
                    td.vlm_batches(256, 8, 32, 3, 12, 2, seed=5))
        arch = "phi3_vision_4p2b"
    jf = jax_make_batches(jax_smoke(arch), 4, 32, seed=2)
    tf = make_batches(get_smoke_config(arch), 4, 32, seed=2)
    pairs = list(pairs) + [(jf(step), tf(step)) for step in (0, 7)]
    for a, b in pairs:
        assert set(a) == set(b)
        for key in a:
            x, y = np.asarray(a[key]), b[key]
            assert x.dtype == y.dtype and x.shape == y.shape
            np.testing.assert_array_equal(x, y)
    if family == "vlm":
        assert tf(0)["tokens"].shape == (4, 24) and tf(0)["img_embeds"].shape == (4, 8, 32)
    else:
        assert tf(0)["mask"].dtype == np.bool_ and tf(0)["features"].shape == (4, 32, 16)


def test_hubert_prefill_encodes_non_causally_without_a_cache(monkeypatch):
    """prefill is the encode: JAX's logits, a cache of None, every layer's
    K2 call non-causal (a later frame moves an earlier position's output);
    there is no decode step and no decode cache, as in JAX."""
    from repro.models import model as JM
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.models import attention

    jcfg, vals, cfg, params = _setup("hubert_xlarge")
    feats = np.random.default_rng(4).standard_normal((B, S, cfg.frame_dim)).astype(np.float32)
    calls = []
    real = ops.flash_attention

    def recording(q, k, v, *, causal=True, scale=None):
        calls.append(causal)
        return real(q, k, v, causal=causal, scale=scale)

    monkeypatch.setattr(attention.ops, "flash_attention", recording)
    logits, cache = _M().prefill(cfg, params, {"features": to_torch(feats)})
    assert cache is None and calls == [False] * cfg.n_layers
    jlogits, jcache = JM.prefill(jcfg, vals, {"features": to_jax(feats)})
    assert jcache is None
    assert_close(logits, jlogits, rtol=TOL, atol=TOL)
    later = feats.copy()
    later[:, -1] += 1.0  # only the last frame changes
    moved, _ = _M().prefill(cfg, params, {"features": to_torch(later)})
    assert float((moved[:, 0] - logits[:, 0]).abs().max()) > 1e-3
    with pytest.raises(ValueError, match="encoder-only"):
        _M().decode_step(cfg, params, None, torch.zeros(B, 1, dtype=torch.long), S)
    with pytest.raises(ValueError, match="encoder-only"):
        _M().init_cache(cfg, B, S, device="cpu")
    with pytest.raises(ValueError, match="encoder-only"):
        JM.decode_step(jcfg, vals, None, jnp.zeros((B, 1), jnp.int32), S)


def _jax_decode_logits(cache_len: int, steps: int, prompt: int):
    """JAX's model-level VLM loop on the smoke config: prefill, its KV
    written into a cache of cache_len positions (dynamic_update_slice, as
    JAX's CLI), then `steps` greedy steps at n_img + prompt + i; the step
    logits."""
    from repro.models import model as JM

    jcfg, vals, cfg, _ = _setup("phi3_vision_4p2b")
    rng = np.random.default_rng(7)
    batch = {"tokens": jnp.asarray(rng.integers(0, cfg.vocab, (B, prompt)), jnp.int32),
             "img_embeds": jnp.asarray(rng.standard_normal((B, cfg.n_img_tokens,
                                                            cfg.vision_dim)), jnp.float32)}
    logits, pre = JM.prefill(jcfg, vals, batch)
    cache = jax.tree.map(lambda full, part: jax.lax.dynamic_update_slice(
        full, part.astype(full.dtype), (0,) * full.ndim), JM.init_cache(jcfg, B, cache_len), pre)
    step = jax.jit(functools.partial(JM.decode_step, jcfg))
    tok = jnp.argmax(logits[:, -1, :], axis=-1).astype(jnp.int32)[:, None]
    out = []
    for i in range(steps):
        lg, cache = step(vals, cache, tok, jnp.asarray(cfg.n_img_tokens + prompt + i, jnp.int32))
        out.append(np.asarray(lg))
        tok = jnp.argmax(lg[:, -1, :], axis=-1).astype(jnp.int32)[:, None]
    return out


def test_jax_cli_cache_is_short_for_the_vlm():
    """A property of the reference, which the port does not copy: JAX's CLI
    sizes the VLM cache prompt + gen, though the prefill fills n_img +
    prompt positions; the decode writes past its end clamp into the last
    slot, and the last steps' logits part from those of a cache of n_img +
    prompt + gen (the size the port serves with)."""
    prompt, gen = 8, 12
    n_img = _setup("phi3_vision_4p2b")[2].n_img_tokens
    short = _jax_decode_logits(prompt + gen, gen - 1, prompt)
    full = _jax_decode_logits(n_img + prompt + gen, gen - 1, prompt)
    # steps writing inside the short cache agree ...
    first_clamped = prompt + gen - n_img - prompt  # step i writes n_img + prompt + i
    for i in range(first_clamped):
        np.testing.assert_allclose(short[i], full[i], rtol=1e-5, atol=1e-5)
    # ... and the last one, after n_img - 1 clamped writes, does not
    assert float(np.abs(short[-1] - full[-1]).max()) > 1e-2


def test_serve_cli_runs_phi3_vision_with_the_longer_cache(capsys):
    """--arch phi3_vision_4p2b --device cpu: JAX's CLI draws (prompts, then
    image embeddings from one generator), a cache of n_img + prompt + gen
    positions whose head is the prefill's, decode at positions n_img +
    prompt + i, and tokens greedy over the teacher-forced forward."""
    from repro_torch.launch import serve
    from repro_torch.models import model as M

    out = serve.run(serve.parse_args(["--arch", "phi3_vision_4p2b", "--batch", "2",
                                      "--prompt-len", "6", "--gen", "5", "--seed", "3",
                                      "--device", "cpu", "--json"]))
    assert "generated token ids" in capsys.readouterr().out
    cfg, params, tokens, batch = out["cfg"], out["params"], out["tokens"], out["batch"]
    n_img = cfg.n_img_tokens
    rng = np.random.default_rng(3)  # JAX's CLI's draws, in its order
    np.testing.assert_array_equal(batch["tokens"].numpy(), rng.integers(0, cfg.vocab, (2, 6)))
    img = rng.standard_normal((2, n_img, cfg.vision_dim)).astype(np.float32)
    np.testing.assert_array_equal(batch["img_embeds"].numpy(), img)
    assert out["payload"]["n_img_tokens"] == n_img
    for name in ("k", "v"):
        full, pre = out["cache"]["layers"][name], out["prefill_cache"]["layers"][name]
        assert full.shape[2] == n_img + 6 + 5 and pre.shape[2] == n_img + 6
        assert torch.equal(full[:, :, :n_img + 6], pre)
        assert bool((full[:, :, n_img + 6 + 4:] == 0).all())  # gen - 1 steps written
    seq = torch.cat([batch["tokens"], tokens], dim=1)
    logits, _ = M.forward(cfg, params, {**batch, "tokens": seq})
    assert torch.equal(torch.argmax(logits[:, n_img + 5: n_img + 10, :], dim=-1), tokens)


def _three_steps(arch, jopt, topt):
    """Three steps of JAX's jitted train step and the port's from one state:
    (JAX state, port state, JAX losses, port losses, initial params)."""
    from repro.runtime import steps as JS
    from repro_torch.convert import train_state_from_numpy
    from repro_torch.launch.train import make_batches
    from repro_torch.runtime import steps

    jcfg, _, cfg, _ = _setup(arch)
    jstate = JS.init_train_state(jcfg, jopt, jax.random.PRNGKey(0))
    state = train_state_from_numpy(cfg, jax.tree.map(np.asarray, jstate), device="cpu")
    p0 = [np.asarray(x, np.float32) for x in jax.tree.leaves(jstate["params"])]
    jstep, step = jax.jit(JS.make_train_step(jcfg, jopt)), steps.make_train_step(cfg, topt)
    batches = make_batches(cfg, 4, S, seed=0)
    jl, tl = [], []
    for i in range(3):
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batches(i).items()})
        state, m = step(state, batches(i))  # numpy batches: the step moves them
        jl.append(float(jm["loss"]))
        tl.append(float(m["loss"]))
    return jstate, state, jl, tl, p0


@pytest.mark.parametrize("which", ["sgd", "adamw"])
@pytest.mark.parametrize("arch", ARCHS)
def test_three_train_steps_match_jax(arch, which):
    from repro.optim import adamw as jadamw, sgd as jsgd
    from repro_torch.convert import train_state_to_numpy
    from repro_torch.optim import adamw, sgd

    lr = 0.5 if which == "sgd" else 1e-3
    jopt, topt = (jsgd(lr), sgd(lr)) if which == "sgd" else (jadamw(lr), adamw(lr))
    jstate, state, jl, tl, p0 = _three_steps(arch, jopt, topt)
    for a, b in zip(tl, jl):
        assert abs(a - b) <= LOSS_RTOL * abs(b), (tl, jl)
    assert int(state["step"]) == 3
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


@pytest.mark.parametrize("arch", ARCHS)
def test_train_state_checkpoints_cross_between_the_packages(arch, tmp_path):
    """A state the port saves restores in JAX, and one JAX saves restores in
    the port, bit for bit, leaf i the same leaf on both sides."""
    from repro.checkpoint import CheckpointManager as JaxManager
    from repro.optim.optimizers import for_arch as jax_for_arch
    from repro.runtime import steps as JS
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.convert import train_state_from_numpy
    from repro_torch.optim import for_arch
    from repro_torch.pytree import leaves
    from repro_torch.runtime import steps

    jcfg, _, cfg, _ = _setup(arch)
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


@pytest.mark.parametrize("arch", ARCHS)
def test_cli_trains_with_a_fault_and_replay_on_cpu(arch, tmp_path, capsys):
    """The smoke configs through the training CLI: a fault at 5 restored
    from 4, the first replayed loss exactly the first pass's, checkpoints at
    4 and 8, the rescale reload; vlm's loss over its text tokens, audio's
    over its masked frames."""
    from repro_torch.launch import train

    out = train.run(train.parse_args([
        "--arch", arch, "--device", "cpu", "--steps", "8", "--batch", "2", "--seq", "24",
        "--ckpt-every", "4", "--inject-fault-at", "5", "--rescale-mesh", "1x1",
        "--ckpt-dir", str(tmp_path / "ck")]))
    assert "(1 faults recovered)" in capsys.readouterr().out
    assert [s for s, _ in out["losses"]] == list(range(5)) + list(range(4, 8))
    assert out["losses"][5][1] == dict(out["losses"][:5])[4]  # the first replayed step
    assert out["ckpt_steps"] == [4, 8] and out["rescaled_step"] == 8
    for m in out["history"]:
        assert np.isfinite(m["loss"]) and m["moe_aux"] == 0.0
        if arch == "phi3_vision_4p2b":
            assert m["n_tokens"] == 2 * (24 - 8 - 1)  # text tokens after the 8 image positions
        else:
            assert 0 < m["n_tokens"] < 2 * 24  # the masked frames
