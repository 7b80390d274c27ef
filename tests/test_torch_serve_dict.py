"""Port checks: launch/serve_dict on the CPU at a tiny size.

Its BENCH line carries exactly the JAX CLI's keys, single service and
fleet, read off the `payload` dicts in src/repro/launch/serve_dict.py's
main() and _run_fleet() by AST (the JAX CLI is not run); its flags and
defaults are the JAX CLI's (read the same way).  The grow and drain drills
and the fleet with a rolling publish run on the CPU, y dims following the
eras; the perturbed dictionary of the publish is JAX's formula bit for
bit."""

import ast
import itertools
import json
import pathlib

import numpy as np
import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
TINY = ["--device", "cpu", "--m", "16", "--atoms-per-agent", "4", "--mesh", "1x4",
        "--samples", "40", "--iters", "30", "--json"]


def _jax_bench_keys(fn="main"):
    tree = ast.parse((REPO / "src/repro/launch/serve_dict.py").read_text())
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == fn)
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
    ["--mesh", "2x4"],
    ["--mesh", "1x2x4"],
    ["--mode", "hier", "--mesh", "1x1x4"],
    ["--drain-at", "2"],
    ["--grow-at", "2", "--drain-at", "2", "--drain", "0"],
    ["--replicas", "0"],
])
def test_cli_refuses_what_is_not_ported(argv):
    from repro_torch.launch import serve_dict

    with pytest.raises(SystemExit):
        serve_dict.main(["--device", "cpu", "--samples", "4"] + argv)


def test_cli_flags_and_defaults_are_the_jax_clis():
    from repro_torch.launch import serve_dict

    tree = ast.parse((REPO / "src/repro/launch/serve_dict.py").read_text())
    jax_defaults = {}
    for n in ast.walk(tree):
        if isinstance(n, ast.Call) and getattr(n.func, "attr", "") == "add_argument":
            flag = n.args[0].value
            kw = {k.arg: k.value for k in n.keywords}
            default = ast.literal_eval(kw["default"]) if "default" in kw else False
            jax_defaults[flag.lstrip("-").replace("-", "_")] = default
    ours = vars(serve_dict.parse_args([]))
    assert set(ours) - set(jax_defaults) == {"device", "transport"}
    assert {k: ours[k] for k in jax_defaults} == jax_defaults
    assert ours["grow_at"] == 300 and ours["grow_model"] == 2


def _eras(results):
    """The y dims of the stream in order, one entry per era."""
    return [k for k, _ in itertools.groupby(y.shape[0] for _, y in results)]


def test_cli_at_the_jax_defaults_grows_at_sample_300():
    from repro_torch.launch import serve_dict

    out = serve_dict.run(serve_dict.parse_args(["--device", "cpu"]))
    (grow,) = out["payload"]["grow_events"]
    assert grow["at_coded"] >= 300 and (grow["model_old"], grow["model_new"]) == (2, 4)
    assert out["payload"]["y_dims"] == [16, 32] and _eras(out["results"]) == [16, 32]
    assert out["swap_s"]["grow"] > 0 and out["swap_s"]["drain"] is None


@pytest.mark.parametrize("argv,eras", [
    pytest.param(["--mode", "graph", "--topology", "erdos", "--grow-at", "16"], [16, 24],
                 id="grow"),
    pytest.param(["--mode", "exact_fista", "--grow-at", "0", "--drain-at", "16",
                  "--drain", "1,2"], [16, 8], id="drain"),
    pytest.param(["--mode", "graph_tv_q8", "--fail-p", "0.25", "--samples", "64",
                  "--grow-at", "16", "--drain-at", "40", "--drain", "0"], [16, 24, 20],
                 id="grow_drain"),
    pytest.param(["--mode", "chain", "--mesh", "2x1x2", "--levels", "ring_metropolis,ring:2:q8",
                  "--samples", "64", "--grow-at", "16", "--grow-model", "1", "--drain-at", "40",
                  "--drain", "2"], [16, 24, 16], id="chain_grow_drain"),
])
def test_cli_grow_and_drain_drills(argv, eras, capsys):
    from repro_torch.launch import serve_dict

    out = serve_dict.run(serve_dict.parse_args(TINY + argv))
    bench = json.loads(next(ln for ln in capsys.readouterr().out.splitlines()
                            if ln.startswith("BENCH "))[len("BENCH "):])
    assert list(bench) == _jax_bench_keys()
    seen = _eras(out["results"])
    assert seen == eras[:len(seen)]  # the eras in order, none revisited
    if "--drain-at" not in argv:
        assert seen == eras  # the CLI waits for a grow before the last batch
    assert bench["y_dims"] == sorted(set(seen))
    assert len(bench["grow_events"]) == ("--grow-at" in argv and argv[argv.index("--grow-at") + 1]
                                         != "0")
    assert len(bench["drain_events"]) == ("--drain-at" in argv)
    svc = out["service"]
    assert svc.stats()["coded"] == bench["samples"] and svc.stats()["fit_failures"] == 0
    assert svc.snapshot().shape[0] * svc.snapshot().shape[2] == eras[-1]


@pytest.mark.parametrize("argv,replicas", [
    pytest.param(["--replicas", "2", "--publish-at", "20"], 2, id="fleet"),
    pytest.param(["--router", "--publish-at", "20", "--mode", "hier", "--mesh", "2x1x2",
                  "--pod-topology", "ring_metropolis"], 1, id="router"),
])
def test_cli_fleet_with_a_rolling_publish(argv, replicas, capsys):
    from repro_torch.launch import serve_dict

    out = serve_dict.run(serve_dict.parse_args(TINY + argv))
    bench = json.loads(next(ln for ln in capsys.readouterr().out.splitlines()
                            if ln.startswith("BENCH "))[len("BENCH "):])
    keys = _jax_bench_keys("_run_fleet")
    assert "per_replica" in keys and list(bench) == keys
    assert bench == json.loads(json.dumps(out["payload"]))
    assert bench["replicas"] == replicas and bench["failed"] == 0
    assert bench["publishes"] == 1
    assert bench["publish_versions"] == {f"r{i}": 1 for i in range(replicas)}
    assert sum(bench["routed"].values()) == 40 == len(out["results"])
    assert _eras(out["results"]) == [16]
    assert all(r["snapshot_version"] == 1 for r in bench["per_replica"].values())
    assert out["fleet"].alive() == []


@pytest.mark.parametrize("nonneg", [False, True])
def test_perturbed_dictionary_is_the_jax_clis(nonneg, monkeypatch):
    from repro_torch.launch import serve_dict

    rng = np.random.default_rng(0)
    W0 = rng.standard_normal((13, 24)).astype(np.float32)
    W0 /= np.linalg.norm(W0, axis=0)
    # src/repro/launch/serve_dict.py:407-413, verbatim
    rng = np.random.default_rng(7)
    W1 = np.asarray(W0) + 0.01 * rng.standard_normal(W0.shape).astype(np.float32)
    if nonneg:
        W1 = np.maximum(W1, 0.0)
    W1 /= np.maximum(1.0, np.linalg.norm(W1, axis=0, keepdims=True))
    for chunk in (30, 1 << 20):  # a row or two per draw, one draw
        monkeypatch.setattr(serve_dict, "_PERTURB_CHUNK", chunk)
        got = serve_dict.perturbed(W0, 7, nonneg)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, W1)
