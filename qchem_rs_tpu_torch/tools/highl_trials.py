"""Launch-shape trials of kernel 1's high-L part on one CUDA card.

Builds the ferrocene/6-31G* engine (the system whose f-shell class pairs
``chip_smoke.py`` times) and launches the high-L part over one build's
f-shell batches under its default schedule and under variants of the
schedule's shared-memory budgets, thread cap and bra-loop split. For each
variant it prints the device time of the part's kernels by class pair and
in all (torch.profiler) and the calls' time in all (CUDA events, host
included), after holding the variant's output against the default's. Then,
under the default schedule, it times each class pair's calls, and the
template part's over a benzene/cc-pVDZ build, with the tile offsets copied
to the card at every call in each way of ``COPIES`` and with the offsets
already on the card (as the direct pass passes them), to part the calls'
host time. Last, it builds copies of ``csrc/eri_tile_highl.cu``
with one stage taken out each (``ABLATIONS``: their outputs are wrong by
design and are not checked) and prints each one's device time by class
pair, to show which stage holds the kernel.

    python -m qchem_rs_tpu_torch.tools.highl_trials    # one CUDA card; about a minute
"""

from __future__ import annotations

import dataclasses
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
REPS = 5
RTOL = 1e-12
#: ways of getting a batch's tile offsets (ti, tj) to the card for one call
COPIES = {
    "two blocking copies": lambda ti, tj: tuple(
        torch.as_tensor(np.asarray(t, dtype=np.int32), device="cuda") for t in (ti, tj)),
    "one pinned copy": lambda ti, tj: tuple(
        torch.from_numpy(np.stack([ti, tj]).astype(np.int32)).pin_memory().to("cuda", non_blocking=True)),
    "one pageable copy": lambda ti, tj: tuple(
        torch.from_numpy(np.stack([ti, tj]).astype(np.int32)).to("cuda", non_blocking=True)),
}
#: stage ablations: (name, text of csrc/eri_tile_highl.cu, its replacement)
ABLATIONS = (
    ("no zero fill", "  const long long nout = g.split_size * nsplit;",
     "  const long long nout = 0;"),
    ("no Boys", "      boys_l(L, al * (px * px + py * py + pz * pz), F);",
     "      for (int n = 0; n <= kMaxL; ++n) F[n] = al * px;"),
    ("no R levels", "    for (int n = L - 1; n >= 0; --n) {", "    for (int n = L - 1; n >= L; --n) {"),
    ("no contraction", "    const int nslice = nreal * S2 * (A4 / kA);", "    const int nslice = 0;"),
    ("no store", "    ob[alpha * astride + s.colo[j] + s2 * plane] = s.odd[s2] ? -v : v;",
     "    if (v == 1.25e-300) ob[alpha * astride + s.colo[j] + s2 * plane] = v;"),
    ("tile kernel exits at once", "  if (nreal == 0) return;", "  if (nreal >= 0) return;"),
)


def events_ms(fn, reps: int = REPS) -> float:
    """Mean milliseconds per ``fn()`` call over ``reps`` calls after a
    warm-up, CUDA events around the whole run."""
    fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def device_ms(fn, reps: int = REPS) -> float:
    """Mean device milliseconds per ``fn()`` call of the high-L part's
    kernels (zero, tile, reduce) under torch.profiler, after a warm-up."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a trace now and then comes back without device events
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events() if e.device_type == DeviceType.CUDA and "highl" in e.name]
        if events:
            return sum(e.time_range.elapsed_us() for e in events) / 1e3 / reps
    raise RuntimeError("three traces in a row held no kernel of the high-L part")


def build_ablations(eri_kernel) -> dict:
    """One launcher of the high-L part per entry of ``ABLATIONS``, built
    from a copy of its source in the build directory (nvcc processes
    started together)."""
    from qchem_rs_tpu_torch.utils import cuda

    source = (cuda.CSRC / eri_kernel.HIGHL_KERNEL.source).read_text()
    cuda.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs, libs = [], {}
    for k, (name, old, new) in enumerate(ABLATIONS):
        if source.count(old) != 1:
            raise RuntimeError(f"ablation {name!r}: its line is not in the source once")
        src = cuda.BUILD_DIR / f"highl_ablation_{k}.cu"
        src.write_text(source.replace(old, new))
        libs[name] = src.with_suffix(".so")
        jobs.append(([cuda.nvcc(), *cuda.NVCC_FLAGS, "-I", str(cuda.CSRC), "-shared", "-o",
                      str(libs[name]), str(src)], name))
    cuda._run(jobs)
    kernels = {}
    for name, lib in libs.items():
        kernels[name] = cuda.CudaKernel(eri_kernel.HIGHL_KERNEL.source, eri_kernel.HIGHL_KERNEL.symbol,
                                        eri_kernel.HIGHL_KERNEL.argtypes)
        kernels[name]._bind(lib, "")
    return kernels


def main() -> int:
    if not torch.cuda.is_available():
        print("highl_trials needs a CUDA card", file=sys.stderr)
        return 2
    from qchem_rs_tpu_torch import BasisSet, MolecularSystem
    from qchem_rs_tpu_torch.ops import eri_kernel
    from qchem_rs_tpu_torch.ops.eri_tiled import TiledEriEngine

    system = MolecularSystem.load(os.path.join(ROOT, "data", "mol", "ferrocene.json"),
                                  BasisSet.load(os.path.join(ROOT, "data", "basis", "6-31G_st.json")))
    engine = TiledEriEngine(system, 1e-12, device="cuda")
    metas = engine.layout.metas
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    by_class: dict = {}
    for b in engine.batches():
        m1, m2 = metas[b[0]], metas[b[1]]
        if max(m1.la + m1.lb, m2.la + m2.lb) > eri_kernel.KERNEL_MAX_SIDE:
            key = "({}{}|{}{})".format(*("spdfghi"[l] for l in (m1.la, m1.lb, m2.la, m2.lb)))
            by_class.setdefault(key, []).append(b)
    batches = [b for bs in by_class.values() for b in bs]

    def shape(b):
        i1, i2, ti, _ = b
        m1, m2 = metas[i1], metas[i2]
        return (m1.la + m1.lb, m2.la + m2.lb, m1.a, m2.a, m1.A, m1.tile, m2.tile, len(ti))

    def run(bs, variant):
        return [engine.bra_batch(*b, fn=lambda *args: eri_kernel.bra_tiles(
            *args, schedule=eri_kernel.highl_schedule(*shape(b), **variant))) for b in bs]

    R, E, C = eri_kernel.HIGHL_BUDGETS
    variants = {
        "default": dict(sms=sms),
        "R budget 32 KiB": dict(sms=sms, budgets=(R // 2, E, C)),
        "R budget 96 KiB": dict(sms=sms, budgets=(R * 3 // 2, E, C)),
        "E1 budget 32 KiB": dict(sms=sms, budgets=(R, 2 * E, C)),
        "sums budget 32 KiB": dict(sms=sms, budgets=(R, E, 2 * C)),
        "threads <= 128": dict(sms=sms, max_threads=128),
        "no bra-loop split": dict(sms=0),
    }
    print(f"{torch.cuda.get_device_name(0)}; {len(batches)} launches of the high-L part over "
          f"{len(by_class)} class pairs of one ferrocene/6-31G* build", flush=True)
    ref = run(batches, variants["default"])
    table = {}
    for name, v in variants.items():
        out = run(batches, v)
        err = max(float((o - r).abs().max() / r.abs().max()) for o, r in zip(out, ref))
        if not err <= RTOL:
            raise RuntimeError(f"variant {name!r} disagrees with the default schedule: {err:.3e}")
        per = {k: device_ms(lambda bs=bs: run(bs, v)) for k, bs in by_class.items()}
        table[name] = (per, device_ms(lambda: run(batches, v)), events_ms(lambda: run(batches, v)))
        print(f"{name}: device {table[name][1]:.4f} ms, calls {table[name][2]:.4f} ms, "
              f"max rel diff from default {err:.2e}", flush=True)
    names = list(variants)
    print("device ms by class pair: class | " + " | ".join(names), flush=True)
    for k in sorted(by_class, key=lambda k: -table["default"][0][k]):
        print(f"{k} | " + " | ".join(f"{table[n][0][k]:.4f}" for n in names), flush=True)
    print("all | " + " | ".join(f"{table[n][1]:.4f}" for n in names), flush=True)
    print("calls | " + " | ".join(f"{table[n][2]:.4f}" for n in names), flush=True)

    print("calls ms by class pair (default schedule), by how the tile offsets reach the card: "
          "class | " + " | ".join(COPIES) + " | already on the card | device", flush=True)

    def copy_ms(eng, bs):
        """The calls' ms of batches ``bs`` of engine ``eng`` under each way of
        COPIES, then with the offsets already on the card."""
        row = [events_ms(lambda: [eng.bra_batch(*b, offsets=copy(b[2], b[3])) for b in bs])
               for copy in COPIES.values()]
        kept = [COPIES["two blocking copies"](ti, tj) for _, _, ti, tj in bs]
        return row + [events_ms(lambda: [eng.bra_batch(*b, offsets=o) for b, o in zip(bs, kept)])]

    for k in sorted(by_class, key=lambda k: -table["default"][0][k]):
        print(f"{k} | " + " | ".join(f"{t:.4f}" for t in copy_ms(engine, by_class[k]))
              + f" | {table['default'][0][k]:.4f}", flush=True)
    print("all | " + " | ".join(f"{t:.4f}" for t in copy_ms(engine, batches))
          + f" | {table['default'][1]:.4f}", flush=True)
    benzene = TiledEriEngine(MolecularSystem.load(
        os.path.join(ROOT, "data", "mol", "benzene.json"),
        BasisSet.load(os.path.join(ROOT, "data", "basis", "cc-pVDZ.json"))), 1e-12, device="cuda")
    print("template part, benzene/cc-pVDZ build | " + " | ".join(
        f"{t:.4f}" for t in copy_ms(benzene, list(benzene.batches()))), flush=True)

    ablations = build_ablations(eri_kernel)
    kernel, abl = eri_kernel.HIGHL_KERNEL, {}
    try:
        for name, k in ablations.items():
            eri_kernel.HIGHL_KERNEL = k
            abl[name] = ({c: device_ms(lambda bs=bs: run(bs, variants["default"]))
                          for c, bs in by_class.items()},
                         device_ms(lambda: run(batches, variants["default"])))
    finally:
        eri_kernel.HIGHL_KERNEL = kernel
    names = ["default"] + list(abl)
    abl["default"] = table["default"][:2]
    print("stage ablations, device ms by class pair: class | " + " | ".join(names), flush=True)
    for k in sorted(by_class, key=lambda k: -table["default"][0][k]):
        print(f"{k} | " + " | ".join(f"{abl[n][0][k]:.4f}" for n in names), flush=True)
    print("all | " + " | ".join(f"{abl[n][1]:.4f}" for n in names), flush=True)

    sched = {k: eri_kernel.highl_schedule(*shape(bs[0]), sms=sms) for k, bs in by_class.items()}
    for k, sc in sched.items():
        print(f"{k}: {dataclasses.astuple(sc)} (W, NI, KB, NT, nsplit, ps), shared memory "
              f"{eri_kernel.highl_smem_bytes(*shape(by_class[k][0])[:2], metas[by_class[k][0][0]].A, sc)} B",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
