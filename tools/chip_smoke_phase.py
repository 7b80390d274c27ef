#!/usr/bin/env python3
"""Run phases of chip_smoke.py alone on the card, after its kernel build:

    python3 tools/chip_smoke_phase.py kernels sharded

calls chip_smoke.phase_<name>(torch, card), or (torch) for a phase that
takes only torch (kernels, small_coder, ...), for each name in turn
(sharded, lm, xlstm, moe_serve, moe_train, granite8b, qwen32b, ...;
`sharded` runs the SHARDED world with its SERVE_MESH and DICT_MESH parts,
then phase_serve_mesh and phase_dict_mesh; SERVE_MESH holds the mesh's
serves against lm's, moe_serve's and fsdp_reference's runs, so those go
first:

    python3 tools/chip_smoke_phase.py lm moe_serve fsdp_reference sharded

) and prints its lines and its seconds.  A quicker look at a phase than
the whole script; the gates are the script's own.
"""

import inspect
import pathlib
import sys
import time
from concurrent.futures import ThreadPoolExecutor

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
    card = chip_smoke.card_line()
    chip_smoke.phase_build()
    for name in sys.argv[1:]:
        t0 = time.perf_counter()
        if name == "sharded":
            with ThreadPoolExecutor(2) as pool:
                job = chip_smoke.dict_mesh_job(chip_smoke.dict_mesh_streams(pool.submit))
            rec = chip_smoke.phase_sharded(torch, card, job)
            print(f"[phase] sharded: {time.perf_counter() - t0:.1f}s on {card}")
            t0 = time.perf_counter()
            chip_smoke.phase_serve_mesh(torch, card, rec.pop("serve_mesh_world"))
            print(f"[phase] serve_mesh: {time.perf_counter() - t0:.1f}s on {card}")
            t0 = time.perf_counter()
            chip_smoke.phase_dict_mesh(torch, card, rec.pop("dict_mesh_world"), job)
            name = "dict_mesh"
        else:
            fn = getattr(chip_smoke, f"phase_{name}")
            fn(*(torch, card)[:len(inspect.signature(fn).parameters)])
        print(f"[phase] {name}: {time.perf_counter() - t0:.1f}s on {card}")
    return 0


if __name__ == "__main__":  # the ranks a phase spawns import this file again
    sys.exit(main())
