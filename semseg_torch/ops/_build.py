"""Build and load the port's CUDA kernels (``semseg_torch/csrc/*.cu``).

Each source compiles with ``nvcc`` into a shared library with a plain C
interface under ``build/semseg_torch_kernels/`` at the repository root and
is loaded with ``ctypes``. The build runs at first use, from the sources in
the checkout only, and again whenever the source or the flags change (a
sha256 stamp sits beside the library). Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
BUILD_DIR = _PKG.parent / "build" / "semseg_torch_kernels"

# sm_90a (Hopper with its architecture-specific features); -Xptxas -v puts
# each kernel's registers, shared memory and spills into the build log.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


@dataclasses.dataclass
class Build:
    path: Path
    seconds: float  # wall time of the nvcc call; 0.0 when the stamp matched
    built: bool
    log: str  # nvcc's output (ptxas resource usage), empty when reused


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin",
                     "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels are built from source at first use")


def build_library(name: str) -> Build:
    """Compile ``csrc/<name>.cu`` into ``libsemseg_<name>.so`` unless a
    library built from the same source and flags is already there."""
    src = _PKG / "csrc" / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()
    lib = BUILD_DIR / f"libsemseg_{name}.so"
    stamp = lib.with_suffix(".so.sha256")
    if lib.is_file() and stamp.is_file() and stamp.read_text() == digest:
        return Build(lib, 0.0, False, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".so.tmp{os.getpid()}")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}) for {src}:\n{log}")
    os.replace(tmp, lib)
    stamp.write_text(digest)
    return Build(lib, seconds, True, log)


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    return ctypes.CDLL(str(build_library(name).path))
