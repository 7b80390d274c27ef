#!/usr/bin/env python3
"""Run one phase of chip_smoke.py alone on the card, after its kernel build:

    python3 tools/chip_smoke_phase.py sharded

calls chip_smoke.phase_<name>(torch, card) for a phase that takes (torch,
card) (sharded, lm, xlstm, moe_serve, moe_train, ...) and prints its lines
and its seconds.  A quicker look at one phase than the whole script; the
gates are the script's own.
"""

import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main() -> int:
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    import chip_smoke

    if not torch.cuda.is_available():
        print("chip_smoke_phase: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = sys.argv[1]
    card = chip_smoke.card_line()
    chip_smoke.phase_build()
    t0 = time.perf_counter()
    getattr(chip_smoke, f"phase_{name}")(torch, card)
    print(f"[phase] {name}: {time.perf_counter() - t0:.1f}s on {card}")
    return 0


if __name__ == "__main__":  # the ranks a phase spawns import this file again
    sys.exit(main())
