"""Port checks: runtime/service and data/synthetic.

The port's streaming service on the CPU (M = 16, N = 4 agents), its
learn reservoir against the JAX one, and the chunked planted stream
against the JAX `sparse_stream`, bit for bit.
"""

import numpy as np
import pytest
import torch

from test_torch_common import rand, unit_cols

M, N_AGENTS, KB = 16, 4, 4


def _service(learn, mode="graph", iters=40, **svc):
    from repro_torch.core.conjugates import make_task
    from repro_torch.core.distributed import DistConfig, DistributedSparseCoder
    from repro_torch.runtime.service import DictionaryService, ServiceConfig

    res, reg = make_task("sparse_svd", gamma=0.05, delta=0.1)
    coder = DistributedSparseCoder(N_AGENTS, res, reg, DistConfig(mode=mode, iters=iters),
                                   device="cpu")
    W0 = unit_cols(rand(np.random.default_rng(0), M, N_AGENTS * KB))
    return coder, DictionaryService(coder, W0, ServiceConfig(
        micro_batch=16, max_wait_s=0.005, learn=learn, mu_w=0.1, **svc))


def test_service_codes_every_sample_and_learns():
    from repro_torch.data.synthetic import sparse_stream

    X = sparse_stream(48, m=M, k_true=N_AGENTS * KB, seed=1)
    coder, svc = _service(learn=True)
    with svc:
        futs = svc.submit_many(X)
        results = [f.result(timeout=120) for f in futs]
    st = svc.stats()
    assert len(results) == 48 and all(f.done() for f in futs)
    assert st["coded"] == st["submitted"] == 48
    assert st["fit_steps"] >= 1 and st["fit_failures"] == 0
    assert st["published"] == st["snapshot_version"] == st["fit_steps"]
    for nu, y in results:
        assert nu.shape == (M,) and y.shape == (N_AGENTS * KB,)
        assert np.isfinite(nu).all() and np.isfinite(y).all()
    assert svc.dictionary().shape == (M, N_AGENTS * KB)
    assert not svc.running()
    with pytest.raises(RuntimeError):
        svc.submit(X[0])


def test_service_codes_equal_coder_solve_on_the_same_snapshot():
    from repro_torch.data.synthetic import sparse_stream

    X = sparse_stream(40, m=M, k_true=N_AGENTS * KB, seed=2)
    coder, svc = _service(learn=False, mode="exact_fista")
    with svc:
        results = [f.result(timeout=120) for f in svc.submit_many(X)]
    snap = svc.snapshot()
    nu, y = coder.solve(snap, X)  # rows are independent problems
    np.testing.assert_allclose(np.stack([r[0] for r in results]), nu.numpy(),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.stack([r[1] for r in results]), y.numpy(),
                               rtol=1e-5, atol=1e-5)
    assert svc.stats()["fit_steps"] == 0


def test_stats_keys_match_the_jax_service():
    import ast
    import pathlib

    src = pathlib.Path(__file__).resolve().parents[1] / "src/repro/runtime/service.py"
    tree = ast.parse(src.read_text())
    stats = next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef) and n.name == "stats")
    jax_keys = {k.value for n in ast.walk(stats) if isinstance(n, ast.Dict)
                for k in n.keys if isinstance(k, ast.Constant)}
    jax_keys -= {"p50", "p95", "p99", "max"}
    _, svc = _service(learn=False, warmup=False)
    assert set(svc.stats()) == jax_keys


def test_learn_reservoir_keeps_the_same_set_as_jax():
    from repro.runtime.service import _LearnReservoir as JaxReservoir
    from repro_torch.runtime.service import _LearnReservoir

    for cap, seed in ((3, 0), (5, 11), (0, 2)):
        ours, theirs = _LearnReservoir(cap, seed), JaxReservoir(cap, seed)
        batches = [np.full((2, 3), i, np.float32) for i in range(40)]
        dropped = [(ours.offer(b), theirs.offer(b)) for b in batches[:25]]
        assert all(a == b for a, b in dropped)
        for _ in range(2):  # the learner takes two, then the stream goes on
            assert float(ours.take(0.01)[0, 0]) == float(theirs.take(0.01)[0, 0])
        for b in batches[25:]:
            assert ours.offer(b) == theirs.offer(b)
        assert (ours.seen, ours.discarded, ours.qsize()) == (
            theirs.seen, theirs.discarded, theirs.qsize())
        kept = [float(ours.take(0.01)[0, 0]) for _ in range(ours.qsize())]
        assert kept == [float(theirs.take(0.01)[0, 0]) for _ in range(len(kept))]
    with pytest.raises(ValueError):
        _LearnReservoir(-1)


@pytest.mark.parametrize("nonneg", [False, True])
def test_chunked_sparse_stream_is_bit_identical(monkeypatch, nonneg):
    from repro.data.synthetic import sparse_stream as jax_stream
    from repro_torch.data import synthetic

    want_X, want_W = jax_stream(20, m=12, k_true=48, nonneg=nonneg, seed=3,
                                return_dictionary=True)
    for chunk in (7, 100, 1 << 24):  # one row per chunk, several rows, one chunk
        monkeypatch.setattr(synthetic, "_CHUNK_VALUES", chunk)
        X, W = synthetic.sparse_stream(20, m=12, k_true=48, nonneg=nonneg, seed=3,
                                       return_dictionary=True)
        assert X.dtype == W.dtype == np.float32
        np.testing.assert_array_equal(W, want_W)
        np.testing.assert_array_equal(X, want_X)
    np.testing.assert_array_equal(synthetic.sparse_stream(5, seed=4), jax_stream(5, seed=4))


def test_service_rejects_bad_samples():
    _, svc = _service(learn=False, warmup=False)
    with pytest.raises(RuntimeError):
        svc.submit(np.zeros(M, np.float32))  # not started
    with svc:
        with pytest.raises(ValueError):
            svc.submit(np.zeros(M + 1, np.float32))
    assert torch.is_tensor(svc.snapshot())
