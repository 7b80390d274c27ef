"""Build the port's hand-written CUDA kernels and load them with ctypes.

Each kernel's source is one `csrc/<name>.cu` file with a plain C interface
(no PyTorch headers), which may include headers beside it in `csrc/`,
compiled by `nvcc` for Hopper (`sm_90a`) into a shared library under
`build/kernels/` at the repository root.  The library name carries a hash
of every file under the kernel's `csrc/` and of the flags, so an edited
source or header is rebuilt and an unchanged one is loaded as it is.  A
kernel is built at its first use (`load`); `build` compiles several
sources at once, one `nvcc` each, all started together.  A failed build
raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
from typing import Dict, Iterable, Optional

KERNELS_DIR = pathlib.Path(__file__).resolve().parent
REPO_ROOT = KERNELS_DIR.parents[2]
BUILD_DIR = REPO_ROOT / "build" / "kernels"

SOURCES: Dict[str, pathlib.Path] = {
    "dict_dual_step": KERNELS_DIR / "dict_dual_step" / "csrc" / "dict_dual_step.cu",
    "flash_attention": KERNELS_DIR / "flash_attention" / "csrc" / "flash_attention.cu",
    "slstm_step": KERNELS_DIR / "slstm_step" / "csrc" / "slstm_step.cu",
}

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, else `nvcc` on PATH, else
    /usr/local/cuda/bin/nvcc.  Raises when there is none."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    if shutil.which("nvcc"):
        candidates.append(shutil.which("nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for path in candidates:
        if path and os.path.exists(path):
            return path
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH); the port's "
        "CUDA kernels are compiled from source at first use"
    )


def library_path(name: str) -> pathlib.Path:
    """Where kernel `name` is built: named by a hash of the flags and of every
    file (name and bytes) under the directory of its source, headers too."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    csrc = SOURCES[name].parent
    for path in sorted(p for p in csrc.rglob("*") if p.is_file()):
        h.update(str(path.relative_to(csrc)).encode() + b"\0" + path.read_bytes() + b"\0")
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Compile the named kernels (default: all), one `nvcc` process per
    source, all running at once.  Returns {name: compiler output} (the
    `-Xptxas -v` register, shared-memory and spill report); a kernel whose
    library is already built reports "cached".  Raises on any failure."""
    names = list(SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    logs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            logs[name] = "cached"
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (
            subprocess.Popen(
                [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            ),
            tmp,
            out,
        )
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built first if needed."""
    with _lock:
        if name not in _libs:
            build([name])
            _libs[name] = ctypes.CDLL(str(library_path(name)))
        return _libs[name]
