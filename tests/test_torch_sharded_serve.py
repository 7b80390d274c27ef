"""Sharded serving over a (data, model) mesh against the port's 1x1 serve and
JAX's single-device model-level loop.

One world of four gloo ranks on the CPU (module-scoped) runs launch/serve's
rank body (`serve._serve_ranks`, what `--mesh` runs) on the SMOKE configs,
fp32, from JAX's params crossed by convert:

  * gemma_2b (MQA: its one kv head stays whole) at 2x2 and 1x4 with the
    cache sharded on its sequence (at 1x4 the last rank's part holds no
    valid position for the prompt's first decode steps), and at 1x2 with
    an odd max_len, where the cache is replicated over `model`;
  * olmo_1b (kv heads sharded) at 1x2 with the sequence-sharded cache
    filled through the all_to_all, and with an odd max_len, where the
    cache is sharded on its kv heads;
  * granite_moe_1b_a400m at 1x2 and 2x2 (the decode step's MoE group
    gathered over `data`), and at 1x4 with an odd max_len (two kv heads
    whole over four ranks, S % 4 != 0: the prefill's MoE through the
    expert-sharded capacity dispatch);
  * kimi_k2_1t_a32b's SMOKE (its "dense" and "layers" caches, a shared
    expert column- and row-parallel) at 1x2.

Each case's tokens equal the port's 1x1 serve's and JAX's loop's
(`JM.prefill`, JAX's `_merge_prefill_cache`, its jitted decode step),
every step's logits are within LOGITS_RTOL of the 1x1's, and the cache
gathered from the ranks is the 1x1 cache within CACHE_RTOL (each rank's
shard is its slice).  The MoE configs serve at capacity 4.0, where
nothing drops: the prefill's all-to-all path and the one-device capacity
dispatch drop different tokens (ROADMAP section 3).  The decode step's
expert-sharded dispatch drops the same assignments as one device's, so it
is held at the config's own capacity with drops.  Also: the log-sum-exp
combine against flash_decode; the vocab-parallel argmax on planted ties
(the lowest global index wins, as torch.argmax); MoE training where S
does not divide the model axis (the lifted refusal) against 1x1; the CLI
end to end, with no card, and with a rank that raises.
"""

import dataclasses
import functools
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_mesh_workers as W
from test_torch_common import REPO, SRC

WORLD_TIMEOUT = 300  # seconds the spawned world may run (launch raises past it)
LOGITS_RTOL = CACHE_RTOL = GRAD_RTOL = LOSS_RTOL = MOE_RTOL = 1e-5
COMBINE_RTOL = 1e-5
B, PROMPT = 2, 10
# name: (arch, mesh, gen); max_len = PROMPT + gen (16 divides 2 and 4; 15 neither)
CASES = {
    "gemma 2x2": ("gemma_2b", (2, 2), 6),
    "gemma 1x4 (an empty part)": ("gemma_2b", (1, 4), 6),
    "gemma 1x2 odd max_len (replicated)": ("gemma_2b", (1, 2), 5),
    "olmo 1x2 (all_to_all fill)": ("olmo_1b", (1, 2), 6),
    "olmo 1x2 odd max_len (heads-sharded)": ("olmo_1b", (1, 2), 5),
    "granite-moe 1x2": ("granite_moe_1b_a400m", (1, 2), 6),
    "granite-moe 2x2 (decode group over data)": ("granite_moe_1b_a400m", (2, 2), 6),
    "granite-moe 1x4 odd max_len": ("granite_moe_1b_a400m", (1, 4), 5),
    "kimi-k2 1x2": ("kimi_k2_1t_a32b", (1, 2), 6),
}
LAYOUTS = {"gemma 2x2": "seq", "gemma 1x4 (an empty part)": "seq",
           "gemma 1x2 odd max_len (replicated)": "replicated",
           "olmo 1x2 (all_to_all fill)": "seq",
           "olmo 1x2 odd max_len (heads-sharded)": "heads",
           "granite-moe 1x4 odd max_len": "replicated"}
TIE_MESHES = ((1, 4), (2, 2))
MOE_MESHES = ((1, 2), (2, 2))
# MoE training with S % tp != 0: 1x2 splits the groups over no data axis,
# 2x2 with one group gathers the tokens over `data`.
TRAIN = {"granite-moe 1x2, S 15": ((1, 2), {}),
         "granite-moe 2x2, S 15, one group": ((2, 2), {"moe_groups": 1})}
TRAIN_B, TRAIN_S = 4, 15


def _overrides(arch, capacity=4.0):
    if arch in ("gemma_2b", "olmo_1b"):
        return {}
    return {"capacity_factor": capacity, "moe_wire_dtype": "native"}


def _cfg(arch, **extra):
    from repro_torch.configs import get_smoke_config

    return dataclasses.replace(get_smoke_config(arch), **{**_overrides(arch), **extra})


def _jax_cfg(arch, **extra):
    from repro.configs import get_smoke_config

    return dataclasses.replace(get_smoke_config(arch), **{**_overrides(arch), **extra})


@functools.lru_cache(maxsize=None)
def _params(arch, **extra):
    import jax

    from repro.models import model as JM
    from repro.models.layers import split_tree

    vals, _ = split_tree(JM.init(_jax_cfg(arch, **extra), jax.random.PRNGKey(0)))
    return jax.tree.map(np.asarray, vals)


def _args(arch, gen, mesh="1x1"):
    from repro_torch.launch import serve

    return vars(serve.parse_args(["--arch", arch, "--batch", str(B), "--prompt-len",
                                  str(PROMPT), "--gen", str(gen), "--device", "cpu",
                                  "--mesh", mesh]))


def _planted_ties():
    """(4, 64) logits whose row maxima tie: row 0 at 5 and 40 (two ranks'
    shards), row 1 at 17 and 18 (one rank's), row 2 at 63, 33 and 3 (three
    ranks' at 1x4, two at 2x2), row 3 equal everywhere."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 64)).astype(np.float32)
    for row, cols in ((0, (5, 40)), (1, (17, 18)), (2, (63, 33, 3))):
        x[row, list(cols)] = 9.0
    x[3] = 1.5
    return x


def _moe_job():
    cfg = _cfg("granite_moe_1b_a400m", capacity_factor=1.25)
    x = np.random.default_rng(11).standard_normal((8, 1, cfg.d_model)).astype(np.float32)
    return {"cfg": cfg, "params": _params("granite_moe_1b_a400m", capacity_factor=1.25),
            "x": x}


def _train_batch():
    rng = np.random.default_rng(13)
    return {"tokens": rng.integers(0, 256, (TRAIN_B, TRAIN_S)).astype(np.int32)}


@pytest.fixture(scope="module")
def world():
    from repro_torch.runtime import mesh

    job = {
        "serve": {name: {"cfg": _cfg(arch), "params": _params(arch), "mesh": shape,
                         "args": _args(arch, gen, "x".join(map(str, shape)))}
                  for name, (arch, shape, gen) in CASES.items()},
        "ties": _planted_ties(), "ties_meshes": TIE_MESHES,
        "moe": _moe_job(), "moe_meshes": MOE_MESHES,
        "train": {name: {"cfg": _cfg("granite_moe_1b_a400m", **extra),
                         "params": _params("granite_moe_1b_a400m", **extra),
                         "batch": _train_batch(), "mesh": shape}
                  for name, (shape, extra) in TRAIN.items()},
    }
    return mesh.launch(W.sharded_serve, (2, 2), device="cpu", threads=1, quiet=True,
                       args=(job,), timeout=WORLD_TIMEOUT)


@functools.lru_cache(maxsize=None)
def _one_device(arch, gen):
    """The port's 1x1 serve of the same case (serve.run, in process)."""
    from unittest import mock

    from repro_torch.convert import lm_params_from_numpy
    from repro_torch.launch import serve

    cfg = _cfg(arch)
    with mock.patch.object(serve, "_config", lambda args: cfg), \
            mock.patch.object(serve.M, "init", lambda c, seed, device: lm_params_from_numpy(
                c, _params(arch), device=device)):
        run = serve.run(serve.parse_args(["--arch", arch, "--batch", str(B), "--prompt-len",
                                          str(PROMPT), "--gen", str(gen), "--device", "cpu"]))
    return {"tokens": run["tokens"].numpy(),
            "logits": [t.numpy() for t in [run["last_logits"]] + run["step_logits"]],
            "cache": {s: {n: t.numpy() for n, t in kv.items()} for s, kv in run["cache"].items()}}


@functools.lru_cache(maxsize=None)
def _jax_tokens(arch, gen):
    """JAX's single-device model-level loop on the same prompts (the JAX
    CLI's `_merge_prefill_cache` and jitted decode step)."""
    import jax
    import jax.numpy as jnp

    from repro.launch.serve import _merge_prefill_cache as jax_merge
    from repro.models import model as JM
    from repro.runtime import steps as JS

    jcfg = _jax_cfg(arch)
    vals = jax.tree.map(jnp.asarray, _params(arch))
    prompts = jnp.asarray(np.random.default_rng(0).integers(0, jcfg.vocab, (B, PROMPT)),
                          jnp.int32)
    logits, pre = JM.prefill(jcfg, vals, {"tokens": prompts})
    cache = jax_merge(jcfg, JM.init_cache(jcfg, B, PROMPT + gen), pre)
    step = jax.jit(JS.make_decode_step(jcfg))
    tok = jnp.argmax(logits[:, -1, :], axis=-1).astype(jnp.int32)[:, None]
    out = [tok]
    for i in range(gen - 1):
        nxt, cache = step(vals, cache, tok, jnp.asarray(PROMPT + i, jnp.int32))
        tok = nxt[:, None]
        out.append(tok)
    return np.asarray(jnp.concatenate(out, 1))


def _close(got, want, rtol, what):
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale, err_msg=what)


@pytest.mark.parametrize("name", list(CASES))
def test_tokens_equal_one_device_and_jax(world, name):
    arch, _, gen = CASES[name]
    got = world[name]
    np.testing.assert_array_equal(got["tokens"], _one_device(arch, gen)["tokens"])
    np.testing.assert_array_equal(got["tokens"], _jax_tokens(arch, gen))
    assert got["agree"], "the model ranks' tokens differ"


@pytest.mark.parametrize("name", list(CASES))
def test_every_steps_logits_match_one_device(world, name):
    arch, _, gen = CASES[name]
    got, one = world[name], _one_device(arch, gen)
    assert len(got["logits"]) == len(one["logits"]) == gen
    for i, (g, w) in enumerate(zip(got["logits"], one["logits"])):
        _close(g, w, LOGITS_RTOL, f"{name} step {i}")


@pytest.mark.parametrize("name", list(CASES))
def test_each_ranks_cache_is_its_slice_of_the_one_device_cache(world, name):
    arch, shape, gen = CASES[name]
    got, one = world[name], _one_device(arch, gen)
    assert got["layout"] == LAYOUTS.get(name, "seq"), got["layout"]
    assert got["seq"] == (got["layout"] == "seq")
    cfg = _cfg(arch)
    b, t, hkv = B // shape[0], PROMPT + gen, cfg.n_kv_heads
    want_local = {"seq": (b, t // shape[1], hkv), "heads": (b, t, hkv // shape[1]),
                  "replicated": (b, t, hkv)}[got["layout"]]
    assert got["local_cache_shape"][:3] == want_local
    assert set(got["cache"]) == set(one["cache"])
    for stack, kv in one["cache"].items():
        for n, w in kv.items():
            _close(got["cache"][stack][n], w, CACHE_RTOL, f"{name} cache {stack}/{n}")


def _flash_decode_inputs(seed, b=3, hq=4, hkv=2, t=20, d=8):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(b, hq, 1, d, generator=g)
    k = torch.randn(b, hkv, t, d, generator=g)
    v = torch.randn(b, hkv, t, d, generator=g)
    return q, k, v


@pytest.mark.parametrize("parts, length", [(2, [20, 13, 1]), (4, [20, 6, 3]), (5, [7, 1, 20])])
def test_lse_combine_matches_flash_decode(parts, length):
    """The parts of one whole cache, each normalised within itself, combined
    by their log-sum-exp: flash_decode over the whole, at COMBINE_RTOL;
    parts past a row's length (no valid key) weigh exactly 0."""
    from repro_torch.kernels.flash_attention import ops

    q, k, v = _flash_decode_inputs(parts)
    length = torch.tensor(length)
    want = ops.flash_decode(q, k, v, length=length)[:, :, 0]
    t_loc = k.shape[2] // parts
    outs = [ops.flash_decode_part(q, k[:, :, r * t_loc:(r + 1) * t_loc],
                                  v[:, :, r * t_loc:(r + 1) * t_loc],
                                  length=(length - r * t_loc).clamp(0, t_loc))
            for r in range(parts)]
    o, m, l_sum = (torch.stack(x) for x in zip(*outs))
    assert torch.isfinite(o).all() and bool((m == -1e30).any())  # some part is empty
    got = ops.combine_decode_parts(o, m, l_sum)
    assert torch.isfinite(got).all()
    _close(got.numpy(), want.numpy(), COMBINE_RTOL, "combine")


@pytest.mark.parametrize("shape", TIE_MESHES)
def test_vocab_parallel_argmax_picks_the_lowest_index_of_a_tie(world, shape):
    x = _planted_ties()
    want = torch.argmax(torch.from_numpy(x), dim=-1).numpy()
    np.testing.assert_array_equal(want, [5, 17, 3, 0])
    for tokens in world[("ties", shape)]:  # every rank's
        np.testing.assert_array_equal(tokens, want)


@pytest.mark.parametrize("shape", MOE_MESHES)
def test_moe_decode_dispatch_with_drops_matches_one_device(world, shape):
    """A decode step's MoE FFN (one group of the step's 8 tokens, the config's
    capacity 1.25: 2 places an expert) with the experts sharded over
    `model`, the group gathered over `data`: the 1x1 dispatch's output and
    aux, drops and all."""
    from repro_torch.convert import lm_params_from_numpy
    from repro_torch.models import model as M
    from repro_torch.models import transformer

    job = _moe_job()
    cfg = job["cfg"]
    params = M.cast_params(cfg, lm_params_from_numpy(cfg, job["params"], "cpu"))
    moe = params["layers"][0]["moe"]
    x = torch.from_numpy(job["x"])
    want, aux = transformer._moe_ffn(moe, x, cfg, 1)
    from repro_torch.models.moe import apply_moe

    _, _, tables = apply_moe(moe, x, top_k=cfg.top_k, n_groups=1,
                             capacity_factor=cfg.capacity_factor, return_tables=True)
    dropped = int((tables["slot"] == cfg.n_experts * tables["cap"]).sum())
    assert dropped > 0, "the case must drop assignments"
    got = world[("moe", shape)]
    _close(got["out"], want.numpy(), MOE_RTOL, f"moe decode {shape}")
    assert abs(got["aux"] - float(aux)) <= MOE_RTOL * abs(float(aux))


@functools.lru_cache(maxsize=None)
def _train_one_device(name):
    from repro_torch.convert import lm_params_from_numpy
    from repro_torch.models import model
    from repro_torch.pytree import leaves

    extra = TRAIN[name][1]
    cfg = _cfg("granite_moe_1b_a400m", **extra)
    params = lm_params_from_numpy(cfg, _params("granite_moe_1b_a400m", **extra), "cpu")
    flat = leaves(params)
    for p in flat:
        p.requires_grad_(True)
    loss, _ = model.loss_fn(cfg, params, {"tokens": torch.from_numpy(_train_batch()["tokens"])})
    return float(loss.detach()), [g.numpy() for g in torch.autograd.grad(loss, flat)]


@pytest.mark.parametrize("name", list(TRAIN))
def test_moe_training_where_s_does_not_divide_the_model_axis(world, name):
    got = world[("train", name)]
    loss, grads = _train_one_device(name)
    assert abs(got["loss"] - loss) <= LOSS_RTOL * abs(loss), (got["loss"], loss)
    assert got["moe_aux"] > 0.0
    assert len(got["grads"]) == len(grads)
    for i, (g, w) in enumerate(zip(got["grads"], grads)):
        _close(g, w, GRAD_RTOL, f"{name} grad leaf {i}")


# -- the CLI --------------------------------------------------------------------


def _cli(argv):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve"] + argv,
        env={**__import__("os").environ, "PYTHONPATH": str(SRC)}, cwd=str(REPO),
        capture_output=True, text=True, timeout=WORLD_TIMEOUT)


def test_cli_serves_on_a_mesh_end_to_end():
    """`--device cpu --mesh 2x2 --json` (gemma SMOKE): exit 0, the JAX CLI's
    lines, a BENCH line whose tokens are the 1x1 CLI's."""
    base = ["--device", "cpu", "--batch", "2", "--prompt-len", "10", "--gen", "6", "--json"]
    proc = _cli(base + ["--mesh", "2x2"])
    assert proc.returncode == 0, proc.stderr[-3000:]
    bench = [json.loads(ln[len("BENCH "):]) for ln in proc.stdout.splitlines()
             if ln.startswith("BENCH ")]
    assert len(bench) == 1 and "generated token ids" in proc.stdout
    got = bench[0]
    assert (got["mesh"], got["transport"], got["world"]) == ("2x2", "gloo", 4)
    assert got["cache_layout"] == "seq" and got["tokens_agree_over_model"]
    assert got["decode_step_traffic"]["model"][0] > 0  # dense: nothing crosses `data`
    from repro_torch.launch import serve

    one = serve.run(serve.parse_args(base))
    np.testing.assert_array_equal(np.asarray(got["tokens"]), one["tokens"].numpy())


def test_serve_on_a_mesh_without_a_card_raises(monkeypatch):
    from repro_torch.launch import serve

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--mesh", "1x2", "--batch", "2", "--prompt-len", "8", "--gen", "2"])


def test_a_rank_that_raises_fails_the_serve_cli():
    """A batch of 3 over two data ranks: each rank raises splitting it."""
    proc = _cli(["--device", "cpu", "--mesh", "2x1", "--batch", "3", "--prompt-len", "8",
                 "--gen", "2"])
    assert proc.returncode != 0
    assert "B % dp == 0 is needed" in proc.stderr, proc.stderr[-3000:]
