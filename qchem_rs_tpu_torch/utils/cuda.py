"""Build and bind the package's hand-written CUDA kernels.

Each ``csrc/*.cu`` file exposes plain C functions that launch its kernels
on a given stream and return the ``cudaError_t`` of the launch. At first
use it is compiled with ``nvcc`` into a shared library under
``qchem_rs_tpu_torch/_build/`` (keyed by a hash of the source, the shared
``csrc/*.cuh`` headers and the flags, so an edited source or header
rebuilds) and loaded with ``ctypes``. A source built in ``parts`` is
compiled as that many translation units (``-DKERNEL_PART=k``, each
instantiating its share of the kernel's templates), then linked.
``load_all`` compiles every source's units together, one nvcc process per
CPU core at a time.
Nothing is compiled or loaded at import; a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc() -> str:
    """The nvcc executable: $CUDA_HOME/bin/nvcc, else the one on PATH, else
    the toolkit's default install location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def _run(jobs: list[tuple[list[str], str]]) -> str:
    """Run nvcc jobs (command, label), at most one per CPU core at a time;
    raise with every failure's output, else return the compiler output of
    all, each under a line with its label and wall time."""
    width = max(1, os.cpu_count() or 1)
    pending, running, outs, failed = list(jobs), [], [], []
    while pending or running:
        while pending and len(running) < width:
            cmd, label = pending.pop(0)
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            running.append((proc, label, time.perf_counter()))
        proc, label, t0 = running.pop(0)
        out, err = proc.communicate()
        outs.append(f"# nvcc {label}: {time.perf_counter() - t0:.1f} s\n{out}{err}")
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {label} (exit {proc.returncode}):\n{out}\n{err}")
    if failed:
        raise RuntimeError("\n".join(failed))
    return "".join(outs)


class _Build:
    """One library's build: ``jobs`` to compile, then ``finish`` links them
    (for a source built in parts) and returns (library path, report)."""

    def __init__(self, source: str, parts: int):
        src = CSRC / source
        flags = " ".join(NVCC_FLAGS) + f" parts={parts}"
        headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
        key = hashlib.sha256(src.read_bytes() + headers + flags.encode()).hexdigest()[:16]
        self.src = src
        self.lib = BUILD_DIR / f"{src.stem}-{key}.so"
        self.log = self.lib.with_suffix(".ptxas.txt")
        self.tmp = self.lib.with_suffix(f".{os.getpid()}.tmp")
        self.cached = self.lib.exists()
        self.objs: list[Path] = []
        self.jobs: list[tuple[list[str], str]] = []
        if self.cached:
            return
        if parts <= 1:
            cmd = [nvcc(), *NVCC_FLAGS, "-shared", "-o", str(self.tmp), str(src)]
            self.jobs.append((cmd, src.name))
            return
        for k in range(parts):
            obj = self.lib.with_suffix(f".{os.getpid()}.part{k}.o")
            cmd = [nvcc(), *NVCC_FLAGS, f"-DKERNEL_PART={k}", "-c", "-o", str(obj), str(src)]
            self.objs.append(obj)
            self.jobs.append((cmd, f"{src.name} part {k}"))

    def finish(self, report: str) -> tuple[Path, str]:
        if self.cached:
            return self.lib, self.log.read_text() if self.log.exists() else ""
        try:
            if self.objs:
                cmd = [nvcc(), *ARCH_FLAGS, "-shared", "-o", str(self.tmp), *map(str, self.objs)]
                report += _run([(cmd, f"{self.src.name} link")])
        except BaseException:
            self.tmp.unlink(missing_ok=True)
            raise
        finally:
            for obj in self.objs:
                obj.unlink(missing_ok=True)
        self.log.write_text(report)
        os.replace(self.tmp, self.lib)  # atomic: a concurrent build sees a whole library
        return self.lib, report


def _build_all(builds: list[_Build]) -> list[tuple[Path, str]]:
    """Compile every build's jobs together, then link each."""
    jobs = [job for b in builds for job in b.jobs]
    if jobs:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
    try:
        report = _run(jobs)
    except BaseException:
        for b in builds:
            for obj in b.objs:
                obj.unlink(missing_ok=True)
            b.tmp.unlink(missing_ok=True)
        raise
    return [b.finish(_report_of(report, b)) for b in builds]


def _report_of(report: str, b: _Build) -> str:
    """The part of a joint report that belongs to build ``b``."""
    keep, mine = [], False
    for line in report.splitlines(keepends=True):
        if line.startswith("# nvcc "):
            mine = line.startswith(f"# nvcc {b.src.name}")
        if mine:
            keep.append(line)
    return "".join(keep)


def build(source: str, parts: int = 1) -> tuple[Path, str]:
    """Compile ``csrc/<source>`` into a shared library (once per content
    hash). Returns (library path, ptxas report of the build or of the
    cached build)."""
    return _build_all([_Build(source, parts)])[0]


class CudaKernel:
    """One hand-written kernel behind its C launcher, with a launch count.

    ``launches`` grows by one for every launch that the CUDA runtime
    accepted, and nowhere else."""

    def __init__(self, source: str, symbol: str, argtypes: list, parts: int = 1):
        self.source = source
        self.symbol = symbol
        self.argtypes = argtypes
        self.parts = parts
        self.launches = 0
        self.ptxas_report = ""
        self._fn = None

    def _bind(self, lib_path: Path, report: str):
        self.ptxas_report = report
        fn = getattr(ctypes.CDLL(str(lib_path)), self.symbol)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        self._fn = fn
        return fn

    def load(self):
        """Build (if needed) and bind the launcher; returns the ctypes
        function."""
        if self._fn is None:
            self._bind(*build(self.source, self.parts))
        return self._fn

    def launch(self, *args) -> None:
        rc = self.load()(*args)
        if rc != 0:
            raise RuntimeError(f"{self.symbol}: CUDA launch failed with cudaError_t {rc}")
        self.launches += 1


def load_all(kernels: list[CudaKernel]) -> None:
    """Build every kernel's library with all nvcc processes started
    together, then bind them."""
    builds = {}
    for k in kernels:
        if k._fn is None and (k.source, k.parts) not in builds:
            builds[(k.source, k.parts)] = _Build(k.source, k.parts)
    done = dict(zip(builds, _build_all(list(builds.values()))))
    for k in kernels:
        if k._fn is None:
            k._bind(*done[(k.source, k.parts)])


def stream_of(t) -> int:
    """The handle of PyTorch's current CUDA stream on ``t``'s device."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
