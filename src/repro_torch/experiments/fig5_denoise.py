"""Paper Fig. 5: image denoising PSNR: centralized [6] (Mairal) vs the
distributed learner with (a) all agents informed and (b) a single informed
agent.  Torch twin of benchmarks/fig5_denoise.py.  Synthetic piecewise-smooth
images stand in for van Hateren, so the claim is the ordering/parity, not the
absolute 21.9x dB numbers.

The images and patches are the JAX script's (the same numpy generators);
the initial dictionaries come from torch generators, so the PSNRs match the
JAX script's statistically, not bit for bit.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.baselines import MairalConfig, MairalLearner
from repro_torch.core.denoise import denoise_image, psnr
from repro_torch.core.learner import DictionaryLearner, LearnerConfig
from repro_torch.data import synthetic as ds
from repro_torch.device import resolve_device
from repro_torch.experiments.common import emit, main, save_json


def run(patch: int = 6, n_patches: int = 6000, img_size: int = 48, sigma: float = 0.15,
        device: str = "cuda"):
    dev = resolve_device(device)
    m = patch * patch
    k = 2 * m  # 2x-overcomplete, like the paper's 100x196
    imgs = ds.synthetic_images(24, img_size, seed=0)
    patches = torch.as_tensor(ds.patch_dataset(imgs, patch=patch, n_patches=n_patches, seed=1),
                              device=dev)

    clean_np = ds.synthetic_images(1, img_size, seed=123)[0]
    clean = torch.as_tensor(clean_np, device=dev)
    noisy = torch.as_tensor(ds.noisy_version(clean_np[None], sigma, seed=7)[0], device=dev)
    p_noisy = float(psnr(clean, noisy))

    results = {"noisy_psnr_db": p_noisy}
    # gamma=0.2, delta=0.05: sparse enough that reconstruction depends on the
    # atoms (at the paper's relative gamma, ~45/255); weaker gammas let the
    # elastic-net shrinkage alone do the denoising and the dictionary barely
    # matters (recorded via the untrained anchor below).
    GAMMA, DELTA, MU_W, EPOCHS = 0.2, 0.05, 0.5, 4

    def dist_learner(informed: str) -> float:
        # mu_scale=0.3: below the stability bound so the O(mu^2) bias keeps
        # nu clean enough for dictionary updates (paper Sec. IV-A trade-off)
        cfg = LearnerConfig(
            m=m, k=k, n_agents=k // 6, task="sparse_svd", gamma=GAMMA, delta=DELTA,
            mu=-1.0, inference_iters=600, engine="diffusion", topology="erdos",
            informed=informed, mu_w=MU_W, seed=0, mu_scale=0.3,
        )
        learner = DictionaryLearner(cfg, device=dev)
        state = learner.init_state()
        if informed == "all":
            results["untrained_psnr_db"] = float(
                psnr(clean, denoise_image(learner, state, noisy, patch=patch, stride=2))
            )
        for ep in range(EPOCHS):
            # 1/sqrt(s) decay, the paper's mu_w(s) = 10/s spirit
            learner.cfg = dataclasses.replace(cfg, mu_w=MU_W / (1 + ep) ** 0.5)
            state, _ = learner.fit(state, patches, batch_size=32)
        return float(psnr(clean, denoise_image(learner, state, noisy, patch=patch, stride=2)))

    results["dist_all_informed_psnr_db"] = dist_learner("all")
    results["dist_one_informed_psnr_db"] = dist_learner("one")

    # centralized baseline [6]
    reg = DictionaryLearner(LearnerConfig(m=m, k=k, n_agents=1, engine="exact",
                                          gamma=GAMMA, delta=DELTA), device=dev).reg
    central = MairalLearner(MairalConfig(m=m, k=k, gamma=GAMMA, delta=DELTA, seed=0), reg,
                            device=dev)
    mst = central.init_state()
    for _ in range(EPOCHS):
        mst, _ = central.fit(mst, patches, batch_size=32)
    eval_cfg = LearnerConfig(m=m, k=k, n_agents=1, task="sparse_svd", gamma=GAMMA,
                             delta=DELTA, inference_iters=300, engine="fista")
    ev = DictionaryLearner(eval_cfg, device=dev)
    est = ev.init_state()._replace(W_blocks=mst.W[None])
    results["centralized_mairal_psnr_db"] = float(
        psnr(clean, denoise_image(ev, est, noisy, patch=patch, stride=2))
    )

    for k_, v in results.items():
        emit(f"fig5/{k_}", f"{v:.2f}")
    gain_all = results["dist_all_informed_psnr_db"] - p_noisy
    gain_one = results["dist_one_informed_psnr_db"] - p_noisy
    emit("fig5/dist_gain_all_db", f"{gain_all:.2f}", "paper: ~7.9 dB over noisy")
    emit("fig5/dist_gain_one_db", f"{gain_one:.2f}", "paper: single agent matches")
    emit(
        "fig5/dist_vs_centralized_db",
        f"{results['dist_all_informed_psnr_db'] - results['centralized_mairal_psnr_db']:.2f}",
        "paper: +0.2 dB (21.98 vs 21.77)",
    )
    save_json("fig5_denoise", results)
    return results


if __name__ == "__main__":
    main(run)
