"""Build and bind the package's hand-written CUDA kernels.

Each ``csrc/*.cu`` file exposes a plain C function that launches its kernel
on a given stream and returns the ``cudaError_t`` of the launch. At first
use it is compiled with ``nvcc`` into a shared library under
``qchem_rs_tpu_torch/_build/`` (keyed by a hash of the source and flags, so
an edited source rebuilds) and loaded with ``ctypes``. Nothing is compiled
or loaded at import; a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def nvcc() -> str:
    """The nvcc executable: $CUDA_HOME/bin/nvcc, else the one on PATH, else
    the toolkit's default install location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def build(source: str) -> tuple[Path, str]:
    """Compile ``csrc/<source>`` into a shared library (once per content
    hash). Returns (library path, ptxas report of the build or of the
    cached build)."""
    src = CSRC / source
    key = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"{src.stem}-{key}.so"
    log = lib.with_suffix(".ptxas.txt")
    if lib.exists():
        return lib, log.read_text() if log.exists() else ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed to build {src.name} (exit {proc.returncode}):\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    log.write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)  # atomic: concurrent builders see a whole library
    return lib, log.read_text()


class CudaKernel:
    """One hand-written kernel behind its C launcher, with a launch count.

    ``launches`` grows by one for every launch that the CUDA runtime
    accepted, and nowhere else."""

    def __init__(self, source: str, symbol: str, argtypes: list):
        self.source = source
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self.ptxas_report = ""
        self._fn = None

    def load(self):
        """Build (if needed) and bind the launcher; returns the ctypes
        function."""
        if self._fn is None:
            lib_path, self.ptxas_report = build(self.source)
            fn = getattr(ctypes.CDLL(str(lib_path)), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def launch(self, *args) -> None:
        rc = self.load()(*args)
        if rc != 0:
            raise RuntimeError(f"{self.symbol}: CUDA launch failed with cudaError_t {rc}")
        self.launches += 1


def stream_of(t) -> int:
    """The handle of PyTorch's current CUDA stream on ``t``'s device."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
