"""Port checks: launch/serve (the LM serving loop) on the CPU at the
gemma_2b, xlstm_1p3b, granite_moe_1b_a400m and kimi_k2_1t_a32b smoke
configs.

It prints the JAX CLI's lines (tests/test_serve.py checks the same two),
its tokens are the greedy tokens of the teacher-forced forward (for the
MoE configs on JAX's weights, the tokens of JAX's own loop), it runs on
the card by default and raises without one, and it refuses what is not
ported (a `pod` axis, the families of later slices).
"""

import json

import pytest
import torch

TINY = ["--arch", "gemma_2b", "--batch", "2", "--prompt-len", "10", "--gen", "5",
        "--device", "cpu"]


def _serve():
    from repro_torch.launch import serve

    return serve


def test_cli_prints_its_lines(capsys):
    payload = _serve().main(TINY + ["--json"])
    out = capsys.readouterr().out
    assert "ms/token" in out
    assert "generated token ids" in out
    bench = [ln for ln in out.splitlines() if ln.startswith("BENCH ")]
    assert len(bench) == 1 and json.loads(bench[0][len("BENCH "):]) == payload
    assert payload["batch"] == 2 and payload["gen"] == 5 and payload["device"] == "cpu"
    assert payload["prefill_ms"] > 0 and payload["decode_ms_per_token"] > 0


def test_run_tokens_are_greedy_over_the_forward():
    from repro_torch.models import model as M

    out = _serve().run(_serve().parse_args(TINY))
    cfg, params, tokens = out["cfg"], out["params"], out["tokens"]
    assert tuple(tokens.shape) == (2, 5)
    assert int(tokens.min()) >= 0 and int(tokens.max()) < cfg.vocab
    assert torch.isfinite(out["last_logits"]).all()
    seq = torch.cat([out["prompts"], tokens], dim=1)
    full, _ = M.forward(cfg, params, {"tokens": seq})
    assert torch.equal(torch.argmax(full[:, 9:14, :], dim=-1), tokens)
    # the prompt's KV sits at the head of the serving cache
    for name in ("k", "v"):
        assert torch.equal(out["cache"]["layers"][name][:, :, :10],
                           out["prefill_cache"]["layers"][name])


def test_cli_serves_xlstm(capsys):
    """--arch xlstm_1p3b --device cpu --json: the xlstm family's loop (every
    sLSTM block's recurrence through K3's plain version), greedy over the
    forward, its state caches carried over from the prefill."""
    from repro_torch.models import model as M

    argv = ["--arch", "xlstm_1p3b", "--batch", "2", "--prompt-len", "10", "--gen", "5",
            "--device", "cpu"]
    payload = _serve().main(argv + ["--json"])
    out = capsys.readouterr().out
    assert "ms/token" in out and "generated token ids" in out
    bench = [ln for ln in out.splitlines() if ln.startswith("BENCH ")]
    assert len(bench) == 1 and json.loads(bench[0][len("BENCH "):]) == payload
    assert payload["arch"] == "xlstm-1.3b" and payload["device"] == "cpu"
    run = _serve().run(_serve().parse_args(argv))
    cfg, tokens = run["cfg"], run["tokens"]
    assert tuple(tokens.shape) == (2, 5) and run["cache"] is run["prefill_cache"]
    full, _ = M.forward(cfg, run["params"], {"tokens": torch.cat([run["prompts"], tokens], dim=1)})
    assert torch.equal(torch.argmax(full[:, 9:14, :], dim=-1), tokens)


@pytest.mark.parametrize("arch", ["granite_moe_1b_a400m", "kimi_k2_1t_a32b"])
def test_cli_serves_moe_with_the_jax_tokens(arch, monkeypatch, capsys):
    """--arch <moe> --device cpu, its weights JAX's (the port's init swapped
    for JAX's params, crossed by convert): the tokens are those of JAX's
    serving loop (prefill, JAX's `_merge_prefill_cache`, its jitted decode
    step) on the same prompts, and the prompt's KV (kimi: the "dense" and
    "layers" caches) heads the serving cache."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from repro.configs import get_smoke_config as jax_smoke
    from repro.launch.serve import _merge_prefill_cache as jax_merge
    from repro.models import model as JM
    from repro.models.layers import split_tree
    from repro.runtime import steps as JS
    from repro_torch.convert import lm_params_from_numpy

    b, p, gen = 2, 10, 5
    jcfg = jax_smoke(arch)
    vals, _ = split_tree(JM.init(jcfg, jax.random.PRNGKey(0)))
    monkeypatch.setattr(_serve().M, "init", lambda cfg, seed, device: lm_params_from_numpy(
        cfg, jax.tree.map(np.asarray, vals), device=device))
    argv = ["--arch", arch, "--batch", str(b), "--prompt-len", str(p), "--gen", str(gen),
            "--device", "cpu", "--json"]
    run = _serve().run(_serve().parse_args(argv))
    assert "generated token ids" in capsys.readouterr().out

    prompts = jnp.asarray(np.random.default_rng(0).integers(0, jcfg.vocab, (b, p)), jnp.int32)
    np.testing.assert_array_equal(run["prompts"].numpy(), np.asarray(prompts))
    logits, pre = JM.prefill(jcfg, vals, {"tokens": prompts})
    cache = jax_merge(jcfg, JM.init_cache(jcfg, b, p + gen), pre)
    step = jax.jit(JS.make_decode_step(jcfg))
    tok = jnp.argmax(logits[:, -1, :], axis=-1).astype(jnp.int32)[:, None]
    want = [tok]
    for i in range(gen - 1):
        nxt, cache = step(vals, cache, tok, jnp.asarray(p + i, jnp.int32))
        tok = nxt[:, None]
        want.append(tok)
    np.testing.assert_array_equal(run["tokens"].numpy(), np.asarray(jnp.concatenate(want, 1)))
    assert set(run["cache"]) == set(cache)
    for stack, layers in run["cache"].items():
        for name, full in layers.items():
            assert torch.equal(full[:, :, :p], run["prefill_cache"][stack][name])


def test_depth_cut_keeps_the_widths(capsys):
    """--n-layers cuts depth only: kimi's smoke config at 2 layers keeps its
    dense first layer and one MoE layer; a cut with no MoE layer left, or
    past the config's depth, is refused."""
    argv = ["--arch", "kimi_k2_1t_a32b", "--batch", "2", "--prompt-len", "6", "--gen", "3",
            "--device", "cpu"]
    run = _serve().run(_serve().parse_args(argv + ["--n-layers", "2"]))
    cfg = run["cfg"]
    assert cfg.n_layers == 2 and cfg.first_dense == 1 and cfg.d_model == 64
    assert len(run["params"]["dense_layers"]) == 1 and len(run["params"]["layers"]) == 1
    for bad in ("1", "4"):
        with pytest.raises(SystemExit, match="--n-layers"):
            _serve().main(argv + ["--n-layers", bad])


def test_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [a for a in TINY if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _serve().main(argv)


@pytest.mark.parametrize("argv", [
    ["--mesh", "2x2x2"],  # a `pod` axis (ROADMAP section 1, item 5)
    ["--arch", "zamba2_1p2b", "--n-layers", "1"],  # below attn_every: no shared block
    ["--arch", "hubert_xlarge"],  # encoder-only: no decode loop
    ["--gen", "0"],
])
def test_cli_refuses_what_is_not_ported(argv):
    with pytest.raises(SystemExit):
        _serve().main(TINY + argv)
