"""The dictionary service on a mesh: `launch/serve_dict --transport`,
SPMD with mesh rank 0 as the controller (runtime/service.py's header
protocol, `follow` on every other rank), one agent a rank, the samples
split over `data`.

One world of four gloo ranks on the CPU (module-scoped,
`torch_mesh_workers.serve_dict_runs`) runs serve_dict's rank body at 1x2
and 2x2 without learning, at 2x2 with it (graph_tv: the schedule clock
crosses the protocol), and a service whose stream idles past its groups'
timeout.  Every code is held against the one-process run's, the learned
dictionary against a one-process replay of the micro-batches rank 0
fitted; the CLI runs once end to end on two spawned ranks; the refusals
(growth, drain, the fleet on a mesh; D > 1 without a mesh) name their
ROADMAP items.
"""

import functools
import subprocess
import sys

import numpy as np
import pytest

import torch_mesh_workers as W
from test_torch_common import REPO, SRC

WORLD_TIMEOUT = 240  # seconds the spawned world may run (launch raises past it)
SMALL = ["--device", "cpu", "--m", "16", "--atoms-per-agent", "8", "--micro-batch", "8",
         "--iters", "40", "--samples", "48", "--transport", "gloo"]
RUNS = {
    "graph 1x2 no-learn": ["--mode", "graph", "--mesh", "1x2", "--no-learn"],
    "exact_fista 2x2 no-learn": ["--mode", "exact_fista", "--mesh", "2x2", "--no-learn"],
    # 39 iterations a claim on a period of 2: the clock's offset alternates
    "graph_tv 2x2 learning": ["--mode", "graph_tv", "--mesh", "2x2", "--mu-w", "0.3",
                              "--iters", "39"],
}
RTOL = 1e-5
IDLE = {"timeout_s": 2, "sleep_s": 5}


@functools.lru_cache(maxsize=None)
def _world():
    from repro_torch.runtime import mesh

    rng = np.random.default_rng(5)
    Wf = rng.standard_normal((16, 2 * 8)).astype(np.float32)
    job = {"runs": {name: SMALL + argv for name, argv in RUNS.items()},
           "idle": {**IDLE, "W": Wf / np.linalg.norm(Wf, axis=0),
                    "x": rng.standard_normal((8, 16)).astype(np.float32)}}
    return mesh.launch(W.serve_dict_runs, (2, 2), device="cpu", threads=1, quiet=True,
                       args=(job,), timeout=WORLD_TIMEOUT)


@pytest.fixture(scope="module")
def world():
    return _world()


def _one_process(argv):
    """serve_dict's one-process run of the same stream (`--mesh 1x2`: the
    two agents in this process; the transport dropped)."""
    from repro_torch.launch import serve_dict

    i = argv.index("--mesh")
    argv = argv[:i] + ["--mesh", "1x2"] + argv[i + 2:]
    argv = [a for a in argv if a not in ("--transport", "gloo")]
    out = serve_dict.run(serve_dict.parse_args(argv))
    return out


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30))


@pytest.mark.parametrize("name", [n for n in RUNS if "no-learn" in n])
def test_every_code_on_the_mesh_is_the_one_process_runs(world, name):
    got = world[name]
    want = _one_process(SMALL + RUNS[name])
    assert got["mesh"] == RUNS[name][RUNS[name].index("--mesh") + 1]
    assert len(got["results"]) == len(want["results"]) == 48
    np.testing.assert_array_equal(got["X"], want["X"])
    for part in (0, 1):  # nu, y
        g = np.stack([r[part] for r in got["results"]])
        w = np.stack([r[part] for r in want["results"]])
        assert _rel(g, w) <= RTOL, (name, part, _rel(g, w))
    assert got["payload"]["fit_steps"] == 0 and got["fit_log"] == []
    # K1 is the plain version on the CPU (no launch); every rank made the
    # same engine calls: one warm solve and one solve per micro-batch
    calls = got["engine_calls"]
    assert len(set(calls)) == 1 and calls[0] >= 1 + 48 // 8
    assert got["k1_launches"] == [0] * len(calls)


def test_the_learned_dictionary_is_a_replay_of_rank_0s_fits(world):
    import torch

    from repro_torch.core.conjugates import make_task
    from repro_torch.core.dictionary import full_from_blocks, init_dictionary
    from repro_torch.core.distributed import DistConfig, DistributedSparseCoder

    got = world["graph_tv 2x2 learning"]
    log = got["fit_log"]
    assert len(log) >= 48 // 8 and got["payload"]["published"] >= 1
    res, reg = make_task("sparse_svd", gamma=0.25, delta=0.05)
    coder = DistributedSparseCoder(2, res, reg, DistConfig(mode="graph_tv", iters=39),
                                   device="cpu")
    Wb = coder.snapshot(init_dictionary(torch.Generator().manual_seed(0), 16, 16, device="cpu"))
    for xb, mu_w, t0 in log:
        assert xb.shape == (8, 16)
        Wb = coder.fit_batch(Wb, xb, mu_w, t0)
    want = full_from_blocks(Wb).numpy()
    assert _rel(got["dictionary"], want) <= RTOL
    # every rank: a warm solve and a warm fit, a solve per micro-batch, the fits
    calls = got["engine_calls"]
    assert len(set(calls)) == 1 and calls[0] - 2 - len(log) >= 48 // 8


def test_a_follower_outlives_an_idle_stream_past_its_groups_timeout(world):
    """The follower waits for rank 0's next request longer than the mesh
    groups' (shortened) timeout: that wait is on the world-timeout group."""
    assert world["idle"] is True


def test_the_cli_serves_on_two_spawned_ranks():
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve_dict", "--mode", "graph",
         "--mesh", "1x2", "--json"] + SMALL,
        cwd=str(REPO), env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"},
        capture_output=True, text=True, timeout=WORLD_TIMEOUT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "[mesh] 1x2 over 2 ranks, transport gloo" in proc.stdout
    bench = [line for line in proc.stdout.splitlines() if line.startswith("BENCH ")]
    assert len(bench) == 1 and '"samples": 48' in bench[0]


@pytest.mark.parametrize("argv,match", [
    (["--mesh", "1x2", "--grow-at", "8"], "item 8"),
    (["--mesh", "1x2", "--drain-at", "8", "--drain", "0", "--grow-at", "0"], "item 8"),
    (["--mesh", "1x2", "--replicas", "2"], "item 9"),
    (["--mesh", "1x2", "--router"], "item 9"),
])
def test_the_cli_refuses_what_a_mesh_does_not_run(argv, match):
    from repro_torch.launch import serve_dict

    with pytest.raises(SystemExit, match=match):
        serve_dict.run(serve_dict.parse_args(argv + SMALL))


def test_d_above_one_needs_a_mesh():
    from repro_torch.launch import serve_dict

    argv = [a for a in SMALL if a not in ("--transport", "gloo")]
    with pytest.raises(SystemExit, match="needs --transport"):
        serve_dict.run(serve_dict.parse_args(["--mesh", "2x2"] + argv))


def test_a_service_on_a_mesh_refuses_growth_drain_and_a_publish():
    import torch

    from repro_torch.core.conjugates import make_task
    from repro_torch.core.distributed import DistConfig, DistributedSparseCoder
    from repro_torch.runtime.mesh import Mesh
    from repro_torch.runtime.service import DictionaryService

    res, reg = make_task("sparse_svd", gamma=0.25, delta=0.05)
    mesh = Mesh(("data", "model"), (1, 2), 0, "gloo", torch.device("cpu"), {})
    coder = DistributedSparseCoder(2, res, reg, DistConfig(mode="graph"), device="cpu",
                                   mesh=mesh)
    svc = DictionaryService(coder, torch.zeros((16, 16)))
    with pytest.raises(NotImplementedError, match="item 8"):
        svc.grow(1, torch.Generator())
    with pytest.raises(NotImplementedError, match="item 8"):
        svc.drain([0])
    with pytest.raises(NotImplementedError, match="item 9"):
        svc.install_snapshot(torch.zeros((16, 16)))
    with pytest.raises(RuntimeError, match="gather"):
        svc.dictionary()
