"""Port checks: launch/serve_dict on the CPU at a tiny size.

Its BENCH line carries exactly the JAX CLI's single-service keys, read off
the `payload` dict in src/repro/launch/serve_dict.py's main() by AST (the
JAX CLI is not run)."""

import ast
import json
import pathlib

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
TINY = ["--device", "cpu", "--m", "16", "--atoms-per-agent", "4", "--mesh", "1x4",
        "--samples", "40", "--iters", "30", "--json"]


def _jax_bench_keys():
    tree = ast.parse((REPO / "src/repro/launch/serve_dict.py").read_text())
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    payload = next(
        n.value for n in ast.walk(main)
        if isinstance(n, ast.Assign) and isinstance(n.value, ast.Dict)
        and any(isinstance(t, ast.Name) and t.id == "payload" for t in n.targets)
    )
    return [k.value for k in payload.keys]


@pytest.mark.parametrize("argv", [
    pytest.param(["--mode", "graph"], id="graph"),
    pytest.param(["--mode", "exact_fista"], id="exact_fista"),
    pytest.param(["--mode", "graph_tv_q8", "--fail-p", "0.25"], id="graph_tv_q8"),
    pytest.param(["--mode", "chain", "--mesh", "2x1x2", "--levels",
                  "ring_metropolis,ring:2:q8:stale"], id="chain"),
])
def test_cli_bench_keys_match_jax_single_service(argv, capsys):
    from repro_torch.launch import serve_dict

    payload = serve_dict.main(TINY + argv)
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("BENCH ")]
    assert len(lines) == 1
    bench = json.loads(lines[0][len("BENCH "):])
    keys = _jax_bench_keys()
    assert len(keys) >= 20 and "samples_per_s" in keys
    assert list(bench) == keys
    assert bench == json.loads(json.dumps(payload))
    assert bench["samples"] == 40 and bench["fit_steps"] >= 1
    assert bench["y_dims"] == [16] and bench["replicas"] == 1


@pytest.mark.parametrize("argv", [
    ["--grow-at", "10"],
    ["--drain-at", "10"],
    ["--replicas", "2"],
    ["--router"],
    ["--mesh", "2x4"],
    ["--mesh", "1x2x4"],
    ["--mode", "hier", "--mesh", "1x1x4"],
])
def test_cli_refuses_what_is_not_ported(argv):
    from repro_torch.launch import serve_dict

    with pytest.raises(SystemExit):
        serve_dict.main(["--device", "cpu", "--samples", "4"] + argv)
