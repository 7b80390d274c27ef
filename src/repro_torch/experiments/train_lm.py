"""End-to-end LM training: a ~100M-parameter OLMo-family model for a few
hundred steps on the synthetic Markov token stream, through the
fault-tolerant runner with checkpoints.  Torch twin of examples/train_lm.py,
at its sizes (LM_100M, 300 steps of 16 x 256 tokens, AdamW with a cosine
warmup and no weight decay), on one device: the JAX script's --mesh is
1x1 here (a sharded run is ROADMAP section 1's sharded-training item).

The loss falls from about ln(V) = 6.93 toward the stream's conditional
entropy, ln(8) = 2.08; like the JAX script, the run fails unless the mean
loss of the last 10 steps is more than 1.0 below the first step's.  The
token stream is the JAX script's (the same numpy generator); the weights
come from a torch generator (seed 0).  fp32 compute at head dim 64, so K2
runs its `scalar_fp32` kernel on the card.  `n_layers` and `d_model` cut
the model for a quick run (d_ff 4 d_model, heads of 64).  Checkpoints go to
a fresh directory under build/checkpoints/.

  PYTHONPATH=src python -m repro_torch.experiments.train_lm
  PYTHONPATH=src python -m repro_torch.experiments.train_lm --device cpu \\
      --steps 60 --batch 4 --seq 64 --n-layers 1 --d-model 64
"""

from __future__ import annotations

import dataclasses
import tempfile

from repro_torch.configs.base import ArchConfig
from repro_torch.data.synthetic import TokenStream
from repro_torch.device import resolve_device
from repro_torch.experiments.common import main, save_json
from repro_torch.launch.train import CKPT_ROOT
from repro_torch.optim import adamw
from repro_torch.optim.schedules import cosine_warmup
from repro_torch.runtime.runner import RunnerConfig, TrainRunner

# ~100M-param dense decoder.  The vocab is deliberately small: the stream is
# a random Markov table, so beating the unigram floor is memorization, and
# 1024 x 8 transitions are learned within a few hundred steps.
LM_100M = ArchConfig(
    name="lm-100m", family="dense", n_layers=12, d_model=832, n_heads=13,
    n_kv_heads=13, d_ff=3328, vocab=1024, act="swiglu",
    compute_dtype="float32", attn_block=256,
)


def run(steps: int = 300, batch: int = 16, seq: int = 256, lr: float = 3e-3,
        n_layers: int = 12, d_model: int = 832, device: str = "cuda"):
    dev = resolve_device(device)
    cfg = LM_100M
    if (n_layers, d_model) != (cfg.n_layers, cfg.d_model):
        cfg = dataclasses.replace(cfg, n_layers=n_layers, d_model=d_model,
                                  n_heads=d_model // 64, n_kv_heads=d_model // 64,
                                  d_ff=4 * d_model)
    n = cfg.param_counts()["total"]
    print(f"model: {cfg.name} ({n / 1e6:.0f}M params), mesh 1x1, {batch}x{seq} tokens/step")
    # wd=0: weight decay on the tied embedding fights bigram memorization,
    # which is exactly what this stream rewards
    opt = adamw(cosine_warmup(lr, warmup=30, total=steps), weight_decay=0.0)
    CKPT_ROOT.mkdir(parents=True, exist_ok=True)
    ckpt_dir = tempfile.mkdtemp(prefix="lm100m_", dir=CKPT_ROOT)
    runner = TrainRunner(cfg, "1x1", opt, RunnerConfig(ckpt_dir=ckpt_dir, ckpt_every=100),
                         device=dev)
    stream = TokenStream(cfg.vocab, seed=0, branching=8)

    def batches(step):
        return {"tokens": next(stream.batches(batch, seq, 1, host_index=step))}

    def log(step, metrics):
        print(f"step {step:4d}  loss {metrics['loss']:.4f}")

    _, history = runner.run(batches, steps, metrics_cb=log)
    first = history[0]["loss"]
    last = sum(h["loss"] for h in history[-10:]) / 10
    print(f"\nloss {first:.3f} -> {last:.3f} (stream entropy floor ~2.08; random ~6.93)")
    out = {"params": n, "steps": steps, "first_loss": first, "last10_loss": last,
           "losses": [h["loss"] for h in history], "ckpt_dir": ckpt_dir,
           "ckpt_steps": runner.ckpt.steps()}
    save_json("train_lm", out)
    if not last < first - 1.0:
        raise RuntimeError(f"training did not learn: loss {first:.3f} -> {last:.3f}")
    return out


if __name__ == "__main__":
    main(run)
