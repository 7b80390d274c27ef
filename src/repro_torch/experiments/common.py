"""Shared helpers of the experiment twins: the CSV rows of the JAX
`benchmarks/common.py`, JSON results under build/experiments/ (never the
JAX package's experiments/bench/), and a command line from `run()`'s
signature."""

from __future__ import annotations

import argparse
import inspect
import json
import pathlib
from typing import Callable, Optional, Sequence

ROOT = pathlib.Path(__file__).resolve().parents[3]
OUT = ROOT / "build" / "experiments"


def emit(name: str, value, derived: str = "") -> None:
    """CSV row `name,value,derived` (the contract of benchmarks/run.py)."""
    print(f"{name},{value},{derived}")


def save_json(name: str, payload) -> pathlib.Path:
    OUT.mkdir(parents=True, exist_ok=True)
    p = OUT / f"{name}.json"
    p.write_text(json.dumps(payload, indent=2))
    return p


def main(run: Callable, argv: Optional[Sequence[str]] = None):
    """Call `run` with one `--name` flag per keyword of its signature
    (defaults and types from the signature; `--device` defaults to cuda)."""
    ap = argparse.ArgumentParser(description=inspect.getdoc(inspect.getmodule(run)))
    for name, p in inspect.signature(run).parameters.items():
        ap.add_argument(f"--{name.replace('_', '-')}", dest=name,
                        type=type(p.default), default=p.default)
    return run(**vars(ap.parse_args(argv)))
