"""Image denoising via model-distributed dictionary learning (paper Sec.
IV-B, Alg. 2): train on clean-scene patches, denoise a corrupted image, and
compare the single-informed-agent network against all-informed.  Torch twin
of examples/denoise_image.py, at its sizes.

The images, patches and noise are the JAX script's (the same numpy
generators); the initial dictionaries come from torch generators (the
learner's seed), so the PSNRs match the JAX script's statistically, not
bit for bit.

  PYTHONPATH=src python -m repro_torch.experiments.denoise_image
  PYTHONPATH=src python -m repro_torch.experiments.denoise_image --device cpu
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.denoise import denoise_image, psnr
from repro_torch.core.learner import DictionaryLearner, LearnerConfig
from repro_torch.data import synthetic as ds
from repro_torch.device import resolve_device
from repro_torch.experiments.common import main, save_json


@torch.no_grad()
def run(patch: int = 6, img_size: int = 48, sigma: float = 0.15, n_patches: int = 5000,
        device: str = "cuda"):
    dev = resolve_device(device)
    m = patch * patch

    print("generating synthetic natural-scene stand-ins (offline container)...")
    imgs = ds.synthetic_images(24, img_size, seed=0)
    patches = torch.as_tensor(ds.patch_dataset(imgs, patch=patch, n_patches=n_patches, seed=1),
                              device=dev)
    clean_np = ds.synthetic_images(1, img_size, seed=123)[0]
    clean = torch.as_tensor(clean_np, device=dev)
    noisy = torch.as_tensor(ds.noisy_version(np.asarray(clean_np)[None], sigma, seed=7)[0],
                            device=dev)
    out = {"noisy_psnr_db": float(psnr(clean, noisy))}
    print(f"noisy PSNR: {out['noisy_psnr_db']:.2f} dB")

    for informed in ("all", "one"):
        cfg = LearnerConfig(
            m=m, k=2 * m, n_agents=12, task="sparse_svd", gamma=0.08, delta=0.1,
            mu=-1.0, inference_iters=300, engine="diffusion", topology="erdos",
            informed=informed, mu_w=0.1, seed=0,
        )
        learner = DictionaryLearner(cfg, device=dev)
        state = learner.init_state()
        state, _ = learner.fit(state, patches, batch_size=32)
        den = denoise_image(learner, state, noisy, patch=patch, stride=2)
        out[f"denoised_{informed}_psnr_db"] = float(psnr(clean, den))
        print(f"informed={informed:4s}: denoised PSNR "
              f"{out[f'denoised_{informed}_psnr_db']:.2f} dB "
              f"(paper: single-informed matches all-informed)")
    save_json("denoise_image", out)
    return out


if __name__ == "__main__":
    main(run)
