"""Port parity for the paper's applications: core/detection (novel-document
scores, ROC, AUC), core/denoise (patches, overlap-add, PSNR, denoising) and
the numpy generators they read (data/synthetic), against the JAX package;
then the application properties tests/test_apps.py asserts, through the
port alone.

Tolerances: the generators, roc_curve and auc bit for bit; patch extraction
and reconstruction 1e-6 (F.fold sums the overlaps in another order); solves
and scores 1e-4 relative.
"""

import numpy as np
import pytest
import torch

from test_torch_common import assert_close, one_torch_thread, rand, to_jax, to_torch, unit_cols

pytestmark = pytest.mark.usefixtures("one_torch_thread")

GENERATORS = {
    "synthetic_images": lambda ds: ds.synthetic_images(3, 40, seed=5),
    "noisy_version": lambda ds: ds.noisy_version(ds.synthetic_images(2, 24, seed=1), 0.2, seed=3),
    "patch_dataset": lambda ds: ds.patch_dataset(ds.synthetic_images(4, 24, seed=2), patch=6,
                                                 n_patches=300, seed=4),
    "patch_dataset_with_dc": lambda ds: ds.patch_dataset(ds.synthetic_images(2, 20, seed=2),
                                                         patch=5, n_patches=50, remove_dc=False),
    "topic_documents": lambda ds: ds.topic_documents(m_vocab=80, n_topics=12, docs_per_step=40,
                                                     n_steps=3, seed=6),
}


@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_generators_match_jax_bit_for_bit(name):
    from repro.data import synthetic as jds
    from repro_torch.data import synthetic as tds

    got, want = GENERATORS[name](tds), GENERATORS[name](jds)
    if name == "topic_documents":
        assert got.novel_steps == want.novel_steps
        np.testing.assert_array_equal(got.labels, want.labels)
        got, want = got.docs, want.docs
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_roc_and_auc_match_jax_bit_for_bit():
    from repro.core import detection as jd
    from repro_torch.core import detection as td

    rng = np.random.default_rng(0)
    scores, labels = rng.random(300), rng.integers(0, 2, 300)
    scores[:40] = scores[40:80]  # ties
    for s in (scores, np.round(scores, 1)):
        assert td.auc(s, labels) == jd.auc(s, labels)
        for got, want in zip(td.roc_curve(s, labels, n_thresh=57), jd.roc_curve(s, labels, n_thresh=57)):
            np.testing.assert_array_equal(got, want)
    assert np.isnan(td.auc(scores, np.zeros(300)))
    assert td.auc(np.array([0.9, 0.8, 0.1]), np.array([1, 1, 0])) == 1.0


def test_scores_match_jax():
    """consensus_score at tests/test_apps.py's shapes and settings (N = 8,
    M = 24, K = 32, 5 documents, erdos seed 4, mu_g 0.02, 20000 iterations),
    local_cost and exact_score, all on the same nu."""
    import jax.numpy as jnp

    from repro.core import conjugates as jc, detection as jd
    from repro.core.dictionary import blocks_from_full as jblocks
    from repro.core.inference import exact_infer
    from repro_torch.core import conjugates as tc, detection as td
    from repro_torch.core.dictionary import blocks_from_full
    from repro_torch.core.topology import make_topology

    n, m, k = 8, 24, 32
    rng = np.random.default_rng(1)
    W = unit_cols(np.abs(rand(rng, m, k)))
    h = np.abs(rand(rng, 5, m))
    jres, jreg = jc.make_task("nmf", gamma=0.05, delta=0.1)
    tres, treg = tc.make_task("nmf", gamma=0.05, delta=0.1)
    nu = np.array(exact_infer(jres, jreg, to_jax(W), to_jax(h), iters=400))
    nu_agents = np.broadcast_to(nu, (n,) + nu.shape).copy()
    A = make_topology("erdos", n, seed=4)
    g_j = jd.consensus_score(jres, jreg, jblocks(to_jax(W), n), to_jax(nu_agents), to_jax(h),
                             jnp.asarray(A, jnp.float32), mu_g=0.02, iters=20000)
    Wb = blocks_from_full(to_torch(W), n)
    g_t = td.consensus_score(tres, treg, Wb, to_torch(nu_agents), to_torch(h),
                             torch.as_tensor(A, dtype=torch.float32), mu_g=0.02, iters=20000)
    assert tuple(g_t.shape) == (n, 5)
    assert_close(g_t, g_j, what="consensus")
    assert_close(td.exact_score(tres, treg, to_torch(W), to_torch(nu), to_torch(h)),
                 jd.exact_score(jres, jreg, to_jax(W), to_jax(nu), to_jax(h)), what="exact")
    assert_close(td.local_cost(tres, treg, Wb[2], to_torch(nu), to_torch(h), 1.0, n, 3.0),
                 jd.local_cost(jres, jreg, jblocks(to_jax(W), n)[2], to_jax(nu), to_jax(h),
                               1.0, n, 3.0), what="J_k")


@pytest.mark.parametrize("size,patch,stride", [((20, 20), 6, 1), ((24, 18), 6, 2),
                                               ((23, 17), 5, 3)])
def test_patches_and_overlap_add_match_jax(size, patch, stride):
    from repro.core import denoise as jd
    from repro_torch.core import denoise as td

    img = rand(np.random.default_rng(2), *size)
    p_t, grid_t = td.extract_patches(to_torch(img), patch, stride)
    p_j, grid_j = jd.extract_patches(to_jax(img), patch, stride)
    assert grid_t == tuple(int(g) for g in grid_j)
    assert_close(p_t, p_j, rtol=0, atol=0, what="patches")
    z = rand(np.random.default_rng(3), *p_t.shape)
    assert_close(td.reconstruct_from_patches(to_torch(z), grid_t, size, patch, stride),
                 jd.reconstruct_from_patches(to_jax(z), grid_j, size, patch, stride),
                 rtol=1e-6, atol=1e-6, what="overlap-add")
    noisy = img + 0.1 * rand(np.random.default_rng(4), *size)
    assert_close(td.psnr(to_torch(img), to_torch(noisy)), jd.psnr(to_jax(img), to_jax(noisy)),
                 rtol=1e-6, atol=1e-6)


def test_denoise_image_matches_jax():
    """Both sides denoise with one dictionary, trained by the JAX learner."""
    from repro.core.denoise import denoise_image as jdenoise
    from repro.core.learner import DictionaryLearner as JL, LearnerConfig as JC
    from repro.data import synthetic as ds
    from repro_torch.convert import learner_state_from_numpy
    from repro_torch.core.denoise import denoise_image
    from repro_torch.core.learner import DictionaryLearner, LearnerConfig

    cfg = dict(m=16, k=32, n_agents=4, gamma=0.08, delta=0.1, inference_iters=100,
               engine="fista", mu_w=0.1)
    jl = JL(JC(**cfg))
    js = jl.init_state()
    patches = ds.patch_dataset(ds.synthetic_images(4, 24, seed=0), patch=4, n_patches=96, seed=1)
    js, _ = jl.fit(js, to_jax(patches), batch_size=32)
    tl = DictionaryLearner(LearnerConfig(**cfg), device="cpu")
    ts = learner_state_from_numpy(np.array(jl.dictionary(js)), np.array(js.A),
                                  np.array(js.informed), int(js.step), 4, device="cpu")
    noisy = ds.noisy_version(ds.synthetic_images(1, 20, seed=9), 0.15, seed=5)[0]
    got = denoise_image(tl, ts, noisy, patch=4, stride=2, batch=40)
    assert got.device.type == "cpu" and tuple(got.shape) == (20, 20)
    assert_close(got, jdenoise(jl, js, to_jax(noisy), patch=4, stride=2, batch=40))


def test_denoising_improves_psnr():
    """tests/test_apps.py's denoising property, through the port alone."""
    from repro_torch.core.denoise import denoise_image, psnr
    from repro_torch.core.learner import DictionaryLearner, LearnerConfig
    from repro_torch.data import synthetic as ds

    patches = ds.patch_dataset(ds.synthetic_images(20, 48, seed=0), patch=6, n_patches=4000, seed=1)
    learner = DictionaryLearner(LearnerConfig(
        m=36, k=72, n_agents=12, task="sparse_svd", gamma=0.08, delta=0.1,
        mu=-1.0, inference_iters=150, engine="fista", mu_w=0.1, seed=0,
    ), device="cpu")
    state, _ = learner.fit(learner.init_state(), patches, batch_size=32)
    clean = torch.as_tensor(ds.synthetic_images(1, 48, seed=99)[0])
    noisy = torch.as_tensor(ds.noisy_version(clean.numpy()[None], sigma=0.15, seed=5)[0])
    p_noisy = float(psnr(clean, noisy))
    p_den = float(psnr(clean, denoise_image(learner, state, noisy, patch=6, stride=2)))
    assert p_den > p_noisy + 2.0, f"denoise {p_noisy:.2f} -> {p_den:.2f} dB"


def test_detection_scores_separate_topics():
    """tests/test_apps.py's detection property, through the port alone."""
    from repro_torch.core.detection import auc, exact_score
    from repro_torch.core.inference import fista_infer
    from repro_torch.core.learner import DictionaryLearner, LearnerConfig
    from repro_torch.data import synthetic as ds

    ts = ds.topic_documents(m_vocab=120, n_topics=16, docs_per_step=150,
                            n_steps=2, topics_per_step=3, seed=1)
    learner = DictionaryLearner(LearnerConfig(
        m=120, k=40, n_agents=10, task="nmf", gamma=0.05, delta=0.1,
        mu=-1.0, inference_iters=200, engine="fista", mu_w=0.3, seed=0,
    ), device="cpu")
    state = learner.init_state()
    for _ in range(2):
        state, _ = learner.fit(state, ts.docs[0], batch_size=16)
    h = torch.as_tensor(ts.docs[1])
    labels = np.isin(ts.labels[1], list(ts.novel_steps[1]))
    W = learner.dictionary(state)
    nu = fista_infer(learner.res, learner.reg, W, h, iters=300)
    a = auc(exact_score(learner.res, learner.reg, W, nu, h).numpy(), labels)
    assert a > 0.7, f"AUC {a:.3f}"
