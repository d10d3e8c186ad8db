"""Side trials of kernel 3 (the direct pass's tile values) on one CUDA card.

Builds the naphthalene/cc-pVDZ direct builder (the system whose direct pass
``chip_smoke.py`` times; with ``--highl``, ferrocene/6-31G* and only its
f-shell class pairs, which take kernel 3's high-L part) and, for every
class pair of its pass, times kernel 3 over the pass's batches as
``eri_kernel.swap_sides`` routes it and from the other side (the transposed
blocks from the ket side, or the blocks from the bra side), after holding
the other side's output against the routed one's, beside the old route
over the same tiles (kernel 1 in its own batches, then ``ket_contract``)
and the class pair's bound (``values_kernel_work``). Prints the card's name
and power limit first.

    python -m qchem_rs_tpu_torch.tools.values_trials           # one CUDA card; about a minute
    python -m qchem_rs_tpu_torch.tools.values_trials --highl   # the same on ferrocene's f shells
"""

from __future__ import annotations

import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
REPS = 3
RTOL = 1e-12
#: H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth and FP64
#: outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP64_FLOP_PER_S = 34e12


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


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("values_trials: CUDA is not available; this tool needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from qchem_rs_tpu_torch import BasisSet, MolecularSystem
    from qchem_rs_tpu_torch.ops import eri_kernel
    from qchem_rs_tpu_torch.ops.fock_stream import StreamingFockBuilder
    from qchem_rs_tpu_torch.utils.cuda import load_all

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip(),
          flush=True)
    highl = "--highl" in argv
    load_all([eri_kernel.KERNEL, eri_kernel.HIGHL_KERNEL, eri_kernel.VALUES_KERNEL,
              eri_kernel.VALUES_HIGHL_KERNEL])
    data = os.path.join(ROOT, "data")
    mol, basis = ("ferrocene", "6-31G_st") if highl else ("naphthalene", "cc-pVDZ")
    system = MolecularSystem.load(os.path.join(data, "mol", f"{mol}.json"),
                                  BasisSet.load(os.path.join(data, "basis", f"{basis}.json")))
    builder = StreamingFockBuilder(system, 1e-12, device="cuda")
    eng = builder.engine
    metas = eng.layout.metas
    old_batches = list(eng.batches(values=False))
    routed = eri_kernel.swap_sides
    rows = []
    for i1, i2 in sorted({b[:2] for b in builder.batches}):
        m1, m2 = metas[i1], metas[i2]
        Lb, Lk = m1.la + m1.lb, m2.la + m2.lb
        if highl and max(Lb, Lk) <= eri_kernel.KERNEL_MAX_SIDE:
            continue
        ks = [k for k, b in enumerate(builder.batches) if b[:2] == (i1, i2)]
        ob = [b for b in old_batches if b[:2] == (i1, i2)]

        def values():
            return [builder.tile_values(k) for k in ks]

        here = values()
        eri_kernel.swap_sides = lambda lb, lk: not routed(lb, lk)  # noqa: B023
        try:
            there = values()
            other_ms = events_ms(values)
        finally:
            eri_kernel.swap_sides = routed
        worst = max(float((a - b).abs().max() / max(float(b.abs().max()), 1e-300))
                    for a, b in zip(there, here))
        if not worst <= RTOL:
            print(f"FAIL: the two sides of ({Lb}, {Lk}) differ by {worst:.3e}", flush=True)
            return 1
        del here, there
        ms = events_ms(values)
        old_ms = events_ms(lambda: [eri_kernel.ket_contract(eng.bra_batch(*b), eng._padded[b[1]][0],
                                                            b[3], m2.tile) for b in ob])
        nbytes, flops = eng.values_kernel_work(pairs={(i1, i2)})
        bound = max(nbytes / HBM_BYTES_PER_S, flops / FP64_FLOP_PER_S) * 1e3
        name = "({}{}|{}{})".format(*("spdfghi"[l] for l in (m1.la, m1.lb, m2.la, m2.lb)))
        side = "ket side" if routed(Lb, Lk) else "bra side"
        rows.append((ms, name, side, other_ms, old_ms, bound, worst))
    for ms, name, side, other_ms, old_ms, bound, worst in sorted(rows, reverse=True):
        print(f"class {name}: kernel 3 {ms:.4f} ms from its {side}, {other_ms:.4f} ms from the other "
              f"(max rel difference {worst:.2e}); kernel 1 + ket_contract {old_ms:.4f} ms; bound "
              f"{bound:.4f} ms", flush=True)
    print(f"all class pairs: kernel 3 {sum(r[0] for r in rows):.4f} ms as routed, "
          f"{sum(min(r[0], r[3]) for r in rows):.4f} ms taking each class pair's faster side, "
          f"kernel 1 + ket_contract {sum(r[4] for r in rows):.4f} ms, bound "
          f"{sum(r[5] for r in rows):.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
