"""Shared helpers for the PyTorch port's tests, and the port's own checks:
import hygiene (the port loads neither jax nor the JAX package) and device
selection (the card unless the CPU is asked for).

Inputs cross between the two frameworks as numpy arrays made from a seed;
the JAX side runs on the CPU (JAX_PLATFORMS=cpu), the port with
device="cpu".  A test that needs the card is marked `gpu` and skips inside
its body when there is none.
"""

import functools
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
SRC = REPO / "src"
if str(SRC) not in sys.path:
    sys.path.insert(0, str(SRC))

# Tolerances of the JAX suite: fp32 solves (tests/test_parity_ref_dist.py),
# the dict_dual_step sweep (tests/test_kernels.py) and its bf16 case.
SOLVE_TOL = 1e-4
DD_Y_TOL = 1e-4  # rtol and atol
DD_G_RTOL, DD_G_ATOL = 1e-4, 2e-3
BF16_TOL = 5e-2


def rand(rng: np.random.Generator, *shape, dtype=np.float32) -> np.ndarray:
    return rng.standard_normal(shape).astype(dtype)


def unit_cols(W: np.ndarray) -> np.ndarray:
    return (W / np.linalg.norm(W, axis=0, keepdims=True)).astype(np.float32)


def to_jax(a):
    import jax.numpy as jnp

    return jnp.asarray(a)


def to_torch(a, dtype=None) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t if dtype is None else t.to(dtype)


def as_np(a) -> np.ndarray:
    """numpy float32 view of a jax array or torch tensor (bf16 widened)."""
    if isinstance(a, torch.Tensor):
        return a.detach().float().cpu().numpy()
    return np.asarray(a, np.float32)


def assert_close(got, want, rtol=SOLVE_TOL, atol=SOLVE_TOL, what=""):
    np.testing.assert_allclose(as_np(got), as_np(want), rtol=rtol, atol=atol, err_msg=what)


def assert_bf16_close(got, want, row_ulps=4.0):
    """bf16 output against its plain version: elementwise within one output
    ulp (2^-7 |want|) plus row_ulps x 2^-8 x the largest |want| of the row
    (the last axis), the rule chip_smoke.py holds the card's kernels to."""
    g, w = as_np(got), as_np(want)
    bound = 2.0 ** -7 * np.abs(w) + row_ulps * 2.0 ** -8 * np.abs(w).max(-1, keepdims=True)
    assert (np.abs(g - w) <= bound).all(), float(np.nanmax(np.abs(g - w) - bound))


@pytest.fixture
def one_torch_thread():
    """Run the test with one intra-op thread: at these widths a launch is
    cheaper than waking a pool, and the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def require_cuda():
    """Skip the calling test (from inside its body) when there is no card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run with -m gpu on the card)")


_HYGIENE = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
sys.path.insert(0, {repo!r})
import chip_smoke
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib", "repro.")) or m == "repro")
print(len(names), bad)
assert len(names) >= 70, names
for lm in ("repro_torch.configs.gemma_2b", "repro_torch.models.model",
           "repro_torch.kernels.flash_attention.ops", "repro_torch.launch.serve",
           "repro_torch.configs.xlstm_1p3b", "repro_torch.models.xlstm",
           "repro_torch.kernels.slstm_step.ops", "repro_torch.kernels.slstm_step.ref",
           "repro_torch.core.learner", "repro_torch.core.baselines",
           "repro_torch.core.detection", "repro_torch.core.denoise",
           "repro_torch.experiments.common", "repro_torch.experiments.fig4_convergence",
           "repro_torch.experiments.fig5_denoise", "repro_torch.experiments.table3_auc",
           "repro_torch.experiments.table4_auc_huber", "repro_torch.runtime.serving",
           "repro_torch.runtime.service", "repro_torch.launch.serve_dict",
           "repro_torch.experiments.streaming_quickstart",
           "repro_torch.pytree", "repro_torch.optim", "repro_torch.optim.schedules",
           "repro_torch.optim.optimizers", "repro_torch.optim.compression",
           "repro_torch.checkpoint", "repro_torch.checkpoint.manager",
           "repro_torch.kernels.flash_attention.backward", "repro_torch.runtime.steps",
           "repro_torch.runtime.runner", "repro_torch.launch.train",
           "repro_torch.experiments.quickstart", "repro_torch.experiments.denoise_image",
           "repro_torch.experiments.novel_docs", "repro_torch.experiments.graph_gossip",
           "repro_torch.experiments.multi_pod", "repro_torch.experiments.train_lm",
           "repro_torch.models.moe", "repro_torch.configs.granite_moe_1b_a400m",
           "repro_torch.configs.kimi_k2_1t_a32b"):
    assert lm in names, lm
assert not bad, bad
"""


def test_port_imports_neither_jax_nor_the_jax_package():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(_HYGIENE.format(repo=str(REPO)))],
        env=env, cwd=str(REPO), capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_resolve_device_is_the_card_unless_cpu_is_asked_for():
    from repro_torch.device import resolve_device

    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("mps")
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        assert resolve_device("cuda").type == "cuda"
    else:
        for name in (None, "cuda", "cuda:0"):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                resolve_device(name)


def test_entry_points_default_to_the_card():
    from repro_torch.configs import get_smoke_config
    from repro_torch.convert import learner_state_from_numpy, lm_params_from_numpy
    from repro_torch.core.baselines import MairalConfig, MairalLearner
    from repro_torch.core.conjugates import make_task
    from repro_torch.core.denoise import denoise_image
    from repro_torch.core.distributed import DistConfig, DistributedSparseCoder
    from repro_torch.core.learner import DictionaryLearner, LearnerConfig
    from repro_torch.experiments import (
        common, fig4_convergence, fig5_denoise, table3_auc, table4_auc_huber,
    )
    from repro_torch.launch import serve
    from repro_torch.models import model as M

    res, reg = make_task("sparse_svd")
    cfg = get_smoke_config("gemma_2b")
    lcfg = LearnerConfig(m=4, k=4, n_agents=2, engine="fista", inference_iters=2)
    mcfg = MairalConfig(m=4, k=4)
    img = np.zeros((4, 4), np.float32)
    if torch.cuda.is_available():
        assert DistributedSparseCoder(2, res, reg, DistConfig()).device.type == "cuda"
        assert M.init(cfg)["embed"]["table"].is_cuda
        assert M.init_cache(cfg, 1, 4)["layers"]["k"].is_cuda
        assert DictionaryLearner(lcfg).init_state().W_blocks.is_cuda
        assert MairalLearner(mcfg, reg).init_state().W.is_cuda
    else:
        twins = (fig4_convergence, fig5_denoise, table3_auc, table4_auc_huber)
        for entry in [lambda: DistributedSparseCoder(2, res, reg, DistConfig()),
                      lambda: M.init(cfg),
                      lambda: M.init_cache(cfg, 1, 4),
                      lambda: lm_params_from_numpy(cfg, {}),
                      lambda: serve.run(serve.parse_args([])),
                      lambda: DictionaryLearner(lcfg),
                      lambda: MairalLearner(mcfg, reg),
                      lambda: denoise_image(DictionaryLearner(lcfg), None, img, patch=2),
                      lambda: learner_state_from_numpy(img, np.eye(2), np.ones(2), 0, 2)] + \
                [functools.partial(common.main, twin.run, []) for twin in twins]:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                entry()
    assert DistributedSparseCoder(2, res, reg, DistConfig(), device="cpu").device.type == "cpu"
    assert M.init(cfg, device="cpu")["embed"]["table"].device.type == "cpu"
    learner = DictionaryLearner(lcfg, device="cpu")
    assert learner.init_state().W_blocks.device.type == "cpu"
    assert MairalLearner(mcfg, reg, device="cpu").init_state().W.device.type == "cpu"
    assert denoise_image(learner, learner.init_state(), img, patch=2).device.type == "cpu"
