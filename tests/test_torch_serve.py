"""Port checks: launch/serve (the LM serving loop) on the CPU at the
gemma_2b and xlstm_1p3b smoke configs.

It prints the JAX CLI's lines (tests/test_serve.py checks the same two),
its tokens are the greedy tokens of the teacher-forced forward, it runs on
the card by default and raises without one, and it refuses what is not
ported (a sharded mesh, the families of later slices).
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


def test_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [a for a in TINY if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _serve().main(argv)


@pytest.mark.parametrize("argv", [
    ["--mesh", "2x4"],
    ["--arch", "zamba2_1p2b"],
    ["--arch", "phi3_vision_4p2b"],
    ["--gen", "0"],
])
def test_cli_refuses_what_is_not_ported(argv):
    with pytest.raises(SystemExit):
        _serve().main(TINY + argv)
