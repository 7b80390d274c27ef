"""Device selection for the port's entry points.

The port runs on the card.  `resolve_device` returns CUDA unless the caller
names the CPU, and raises when CUDA was asked for (or left as the default)
and there is no card: an entry point never carries on, quietly, on the CPU.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """torch.device for `device` ("cuda", "cuda:<i>", "cpu"; None = "cuda").

    Raises RuntimeError for a CUDA device when no card is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; the port runs on the card by "
                "default -- pass device='cpu' (or --device cpu) to run on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
