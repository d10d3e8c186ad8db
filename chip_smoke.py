"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds both hand-written kernels from ``qchem_rs_tpu_torch/csrc``, holds
each against its plain PyTorch twin on the card, runs the port's in-core
RHF on water/cc-pVDZ and on benzene/cc-pVDZ (the headline configuration:
diag_rms 1e-8), checks the energies against their anchors, shows that the
benzene run went through both kernels, and times each kernel against its
twin at the benzene shapes. Every phase fails loudly; the script exits
non-zero on any failed check and when CUDA is not available. The last line
is a JSON object naming the device.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
WATER_E = -76.02713907  # water/cc-pVDZ fixed point (diag_rms 1e-10, JAX package on CPU)
BENZENE_E = -230.72299497  # benzene/cc-pVDZ (diag_rms 1e-8, JAX package; noisy to ~1e-7)
KERNEL1_RTOL = 1e-12
KERNEL2_RTOL = 1e-12


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def rel_err(out: torch.Tensor, ref: torch.Tensor) -> tuple[float, float]:
    """(max abs error, max abs error / max |ref|)."""
    err = float((out - ref).abs().max())
    return err, err / float(ref.abs().max())


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` on the card over ``reps`` calls, after one
    warm-up call (CUDA events around the whole run)."""
    fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def check_kernel1(eri_kernel, ncart, nhermite) -> float:
    """Kernel 1 against its twin for every (Lb, Lk) in {0..4}^2, random inputs
    made with numpy, two tiles per call at distinct offsets."""
    rng = np.random.default_rng(7)
    prims = [9, 4, 2, 1, 1]
    worst_abs = 0.0
    for Lb in range(5):
        for Lk in range(5):
            a, c = prims[Lb], prims[Lk]
            T1 = 16 if Lb == 0 else 8
            T2 = 32 if Lk == 0 else (16 if Lk == 1 else 8)
            A, S1 = ncart(Lb), nhermite(Lb)
            N1, N2 = 2 * T1, 2 * T2
            host = [
                rng.standard_normal((N1, a, A, S1)),
                rng.uniform(0.3, 8.0, (N1, a)),
                rng.standard_normal((N1, a, 3)) * 1.5,
                rng.uniform(0.3, 8.0, (N2, c)),
                rng.standard_normal((N2, c, 3)) * 1.5,
            ]
            dev = [torch.tensor(x, device="cuda") for x in host]
            ti, tj = np.array([0, T1]), np.array([T2, 0])
            out = eri_kernel.bra_tiles(Lb, Lk, *dev, ti, tj, T1, T2)
            ref = eri_kernel.bra_tiles_plain(Lb, Lk, *dev, ti, tj, T1, T2)
            torch.cuda.synchronize()
            err, rel = rel_err(out, ref)
            print(f"kernel1 Lb={Lb} Lk={Lk} a={a} c={c} T1={T1} T2={T2}: "
                  f"max rel err {rel:.3e}", flush=True)
            if not rel <= KERNEL1_RTOL:
                fail(f"kernel 1 disagrees with its twin at Lb={Lb} Lk={Lk}: {rel:.3e}")
            worst_abs = max(worst_abs, err)
    return worst_abs


def check_kernel2(fock_matvec) -> tuple[float, float, float]:
    """Kernel 2 against terms @ d at m = 150 and m = 14400 (benzene/cc-pVDZ,
    n = 120); returns (max abs err, kernel ms, twin ms) at m = 14400."""
    worst_abs = 0.0
    gen = torch.Generator(device="cuda").manual_seed(0)
    for m in (150, 14400):
        T = torch.randn((m, m), generator=gen, dtype=torch.float64, device="cuda")
        T = T + T.T
        d = torch.randn(m, generator=gen, dtype=torch.float64, device="cuda")
        out = fock_matvec.matvec(T, d)
        ref = fock_matvec.matvec_plain(T, d)
        torch.cuda.synchronize()
        err, rel = rel_err(out, ref)
        print(f"kernel2 m={m}: max rel err {rel:.3e}", flush=True)
        if not rel <= KERNEL2_RTOL:
            fail(f"kernel 2 disagrees with its twin at m={m}: {rel:.3e}")
        worst_abs = max(worst_abs, err)
    ms = cuda_ms(lambda: fock_matvec.matvec(T, d), 50)
    plain_ms = cuda_ms(lambda: fock_matvec.matvec_plain(T, d), 50)
    gbs = m * m * 8 / (ms * 1e-3) / 1e9
    print(f"kernel2 m={m}: {ms:.4f} ms ({gbs:.0f} GB/s of terms), twin {plain_ms:.4f} ms",
          flush=True)
    del T
    return worst_abs, ms, plain_ms


def run_rhf(Q, mol: str, eps: float, max_iterations: int):
    basis = Q.BasisSet.load(os.path.join(ROOT, "data", "basis", "cc-pVDZ.json"))
    system = Q.MolecularSystem.load(os.path.join(ROOT, "data", "mol", f"{mol}.json"), basis)
    cfg = Q.HartreeFockConfig(epsilon=eps, max_iterations=max_iterations)
    t0 = time.perf_counter()
    out = Q.restricted_hartree_fock(system, cfg, device="cuda")
    wall = time.perf_counter() - t0
    return system, out, wall


def time_kernel1(engine, eri_kernel) -> tuple[float, float, float]:
    """Kernel 1 against its twin over every tile batch of one benzene build:
    (max abs err, kernel ms, twin ms). The twin runs in its own smaller
    batches (its R tables are larger than the kernel's output)."""
    worst_abs = 0.0
    for i1, i2, ti, tj in engine.batches(twin=True):
        out = engine.bra_batch(i1, i2, ti, tj)
        ref = engine.bra_batch(i1, i2, ti, tj, fn=eri_kernel.bra_tiles_plain)
        err, rel = rel_err(out, ref)
        if not rel <= KERNEL1_RTOL:
            fail(f"kernel 1 disagrees with its twin on benzene class pair {i1},{i2}: {rel:.3e}")
        worst_abs = max(worst_abs, err)
    kernel_batches = list(engine.batches())
    twin_batches = list(engine.batches(twin=True))
    ms = cuda_ms(lambda: [engine.bra_batch(*b) for b in kernel_batches], 3)
    plain_ms = cuda_ms(
        lambda: [engine.bra_batch(*b, fn=eri_kernel.bra_tiles_plain) for b in twin_batches], 1
    )
    return worst_abs, ms, plain_ms


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    import qchem_rs_tpu_torch as Q
    from qchem_rs_tpu_torch.ops import eri_kernel, fock_matvec
    from qchem_rs_tpu_torch.ops.angular import ncart
    from qchem_rs_tpu_torch.ops.eri_tiled import TiledEriEngine
    from qchem_rs_tpu_torch.ops.mcmurchie import nhermite

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    # 1. build both kernels from the checkout's sources
    t0 = time.perf_counter()
    for k in (eri_kernel.KERNEL, fock_matvec.KERNEL):
        k.load()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s", flush=True)
    for k in (eri_kernel.KERNEL, fock_matvec.KERNEL):
        for line in k.ptxas_report.splitlines():
            if "Used" in line or "spill" in line or "stack frame" in line:
                print(f"ptxas {k.source}: {line.strip()}", flush=True)

    # 2. each kernel against its twin
    k1_abs = check_kernel1(eri_kernel, ncart, nhermite)
    k2_abs, k2_ms, k2_plain_ms = check_kernel2(fock_matvec)

    # 3. water/cc-pVDZ against its anchor
    _, out, wall = run_rhf(Q, "water", 1e-10, 100)
    dE = out.total_energy() - WATER_E
    print(f"water/cc-pVDZ: E {out.total_energy():.10f} (dE {dE:.2e}), "
          f"{out.iterations} iterations, converged {out.converged}, {wall:.2f} s", flush=True)
    if not (out.converged and abs(dE) <= 1e-8):
        fail("water/cc-pVDZ misses its anchor")

    # 4. the headline: benzene/cc-pVDZ at diag_rms 1e-8, counting launches
    for k in (eri_kernel.KERNEL, fock_matvec.KERNEL):
        k.launches = 0
    system, out, wall = run_rhf(Q, "benzene", 1e-8, 150)
    launches = {"eri_tile": eri_kernel.KERNEL.launches, "fock_matvec": fock_matvec.KERNEL.launches}
    tm = out.timings
    dE = out.total_energy() - BENZENE_E
    engine = TiledEriEngine(system, 1e-12, device="cuda")
    flops = engine.analytic_build_flops()
    print(f"benzene/cc-pVDZ: E {out.total_energy():.10f} (dE {dE:.2e}), "
          f"{out.iterations} iterations, converged {out.converged}", flush=True)
    print(f"benzene/cc-pVDZ timings: one_electron_s {tm['one_electron_s']:.4f}, "
          f"eri_s {tm['eri_s']:.4f}, scf_s {tm['scf_s']:.4f}, total_s {tm['total_s']:.4f}, "
          f"wall {wall:.4f}; analytic build {flops / 1e9:.1f} GFLOP -> "
          f"{flops / tm['eri_s'] / 1e9:.1f} GFLOP/s", flush=True)
    print(f"benzene/cc-pVDZ launches: {launches}", flush=True)
    if not (out.converged and abs(dE) <= 1e-6):
        fail("benzene/cc-pVDZ did not converge to its anchor")
    if not all(v > 0 for v in launches.values()):
        fail(f"the benzene run bypassed a kernel: {launches}")

    # 5. kernel 1 against its twin at the benzene shapes
    k1_bz_abs, k1_ms, k1_plain_ms = time_kernel1(engine, eri_kernel)
    print(f"kernel1 benzene build ({len(list(engine.batches()))} launches): {k1_ms:.3f} ms, "
          f"twin {k1_plain_ms:.3f} ms, max abs err {k1_bz_abs:.3e}", flush=True)

    print(json.dumps({"kernels": [
        {"name": "eri_tile", "route": "cuda", "source": "qchem_rs_tpu_torch/csrc/eri_tile.cu",
         "replaces": "qchem_rs_tpu/ops/eri_pallas.py:205", "launches": launches["eri_tile"],
         "max_abs_err": max(k1_abs, k1_bz_abs), "ms": k1_ms, "plain_ms": k1_plain_ms},
        {"name": "fock_matvec", "route": "cuda",
         "source": "qchem_rs_tpu_torch/csrc/fock_matvec.cu",
         "replaces": "qchem_rs_tpu/ops/fock_matvec.py:82", "launches": launches["fock_matvec"],
         "max_abs_err": k2_abs, "ms": k2_ms, "plain_ms": k2_plain_ms},
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
