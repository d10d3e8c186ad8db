"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py              # the smoke run
    python3 chip_smoke.py --profile    # plus torch.profiler windows over one warm
                                       # benzene run and one naphthalene direct
                                       # pass (device time by kernel), and the
                                       # direct pass at three batch sizes

Builds the hand-written kernels from ``qchem_rs_tpu_torch/csrc`` (every
nvcc process started together; kernel 1 in its two parts, the template
``eri_tile.cu`` and the high-L ``eri_tile_highl.cu``, kernel 2, and kernel
3, the direct pass's tile values, in its two parts ``eri_tile_values.cu``
and ``eri_tile_values_highl.cu``) and prints the build time and ptxas's
registers, stack frame and spills for every instantiation; holds each
kernel against its plain PyTorch twin on the card (kernel 3 for all 25
(Lb, Lk) <= (4, 4) and its high-L part for the 24 class pairs with a side
of 5 or 6, from both sides, with ragged primitive counts, at tile edge 32
and with ket tiles of one pair and empty bra rows, two launches
bit-identical; kernel 1 for all 49 (Lb, Lk) <= (6, 6) with
ragged primitive counts,
and its high-L part in all 24 of its (Lb, Lk) at the (xx|ff) shapes of
ferrocene: ket tiles of one pair, bra tiles of 16, empty bra rows and the
bra loop split over blocks, two launches bit-identical; its Boys function
F_0..F_12 against ``boys``, kernel 2 at m = 150, 14400 and 14401); runs
the port's in-core RHF on water/cc-pVDZ, Cartesian and spherical, and on
benzene/cc-pVDZ (the headline configuration: diag_rms 1e-8), checks the
energies against their anchors, shows that the benzene run went through
both kernels, and times each kernel against its twin, its bound and the
library call at the benzene shapes. Then the scale path: RHF on
naphthalene/cc-pVDZ (SAD guess, diag_rms 1e-8) through the in-core, pair,
lean pair and direct Fock modes and a pair run from the Hückel guess,
each against its anchor, with its peak device memory and the launches of
each kernel; kernel 2 on the pair-space V2f (m = 19136) and W @ dK timed
against their bounds; kernel 3 per direct pass against its twin, its
bound and the old route (kernel 1 + ``ket_contract``) over the same tiles,
and the digestion; and UHF
on OH (doublet) and O2 (triplet) in 6-31G through the three modes. Then
every basis: spherical naphthalene/cc-pVDZ (SAD) and UHF OH/6-31G*
(spherical) in the three modes; ferrocene/6-31G* (Cartesian, f shells on
Fe, SAD) in the three modes, which runs the high-L parts (kernel 1's on
the builds, kernel 3's on the direct passes, and kernel 1 never on a
direct path), kernel 1's timed on the build's f-shell class pairs (CUDA
events around the calls, as every kernel is timed, and its kernels'
device time from torch.profiler, in all and by class pair beside each
class's own bound), kernel 3's on the f-shell class pairs of one direct
pass at the pair SCF's density against its twin (relaunched in equal
bits), against the old route (kernel 1's high-L part + ``ket_contract``)
over the same tiles in turns and by class pair, beside its bound, with
the pass by part (kernel 3's template part, the f-shell class pairs, the
digestion); and the Zn atom in
6-31G* on the card against
the port on the CPU. Then this slice's paths: bitwise repeats (kernel 2
at m = 150, 14400, 14401 and on the naphthalene V2f, a direct J/K pass,
benzene in core and naphthalene pair and direct runs, each twice: equal
energy and density bits and iteration counts); water/cc-pVDZ in a field of
+-1e-3 z (the central difference against ``dipole_moment``, direct against
in core); a benzene checkpoint resumed; MP2 on water/cc-pVDZ against its
anchor, on naphthalene/cc-pVDZ in core and in pair space (frozen 0 and
"auto", after a diag_rms 1e-10 pair SCF and a level-shifted one that
must land on it), with each run's launches, times and peak memory; UMP2
on triplet O2/6-31G in both forms; and the CLI's ``mp2`` subcommand as a
subprocess. Then the correlated tier past MP2: benzene/cc-pVDZ RHF (in
core, SAD, diag_rms 1e-10) and spatial CCSD(T) (the main path of this
tier, both kernels counted over it), then CCSD(T) with frozen 0 and
"auto" in core and in pair space (in core - pair within 1e-9, iteration
0 equal to MP2, a repeat equal in bits), each by part (ERI, MO blocks, CC
iterations, (T)) with its peak memory and launches; water/cc-pVDZ
CCSD(T) spatial against spinorbital, batched (T) against full, and
against its JAX anchor; UCCSD(T) on OH and O2/6-31G, card against CPU;
CIS on naphthalene (pair-mode Davidson against in-core Davidson), dense
TDHF singlets and triplets on benzene, UCIS on O2; FCI on water/STO-3G,
card against CPU; EOM-CCSD (matrix-free spatial on benzene, spinorbital
left and right on water/cc-pVDZ, the determinant tier against the
matrix-free one, IP/EA and transition moments on water/STO-3G); the
unrelaxed and relaxed CCSD dipoles on water/cc-pVDZ against a finite
field; and the CLI's ``ccsd --triples`` as a subprocess. Then the
gradient and geometry tier: benzene/cc-pVDZ RHF (in core, SAD, diag_rms
1e-10) and its analytic gradient (the main path of this tier, both
kernels counted over it; timed by part, with the derivative integrals'
segments and peak memory), gated by D6h symmetry, the sum over atoms, a
central difference of the card's energy, a repeat equal in bits and the
pair-mode gradient; UHF OH/6-31G's gradient, card against CPU; water/
cc-pVDZ optimized, then its harmonic frequencies and thermochemistry, and
the CLI's ``frequencies --opt-first --thermo`` as a subprocess; static
polarizabilities of benzene (in core and pair) and naphthalene (pair);
and the CLI's ``rhf --gradient --polarizability``. Then the multi-device
tier: ``conformer_sweep`` over four benzene/cc-pVDZ conformers (the atoms
scaled about their centre by 0.98-1.04; the main path of this tier, both
kernels counted over it; each energy equal in bits to a single run), the
chained sweep over them (within 1e-9) and over naphthalene/cc-pVDZ scaled
1.00-1.02 in pair and direct mode (within 1e-9 of fresh runs); the three
sharded builders (direct, pair-space, column-sharded) through a real NCCL
group of one rank on naphthalene (J/K within 1e-12 relative of the
unsharded pair build, RHF within 1e-9 Eh, the direct run repeated in
equal bits, each builder's prepare and J/K time and peak memory), sharded
MP2 through both pair builders, rank views of 4 and 3 on the one card
(their shares added in rank order; the column slabs reassembling V2f; the
pair slabs V2f's and W's columns in equal bits, in unequal shares where
the mesh size does not divide M); and the CLI's ``sweep``
and ``sweep --chain`` as subprocesses. NCCL between cards is not run:
there is one card. Every phase
fails loudly; the script exits non-zero
on any failed check and when CUDA is not available. Two lines before the
last are JSON objects: the launches of every path, and one entry per
kernel (the template part and kernel 2 at the benzene in-core shapes, the
high-L part at the ferrocene build's, kernel 3 over a naphthalene direct
pass, its launches those of the naphthalene direct run, and its high-L
part over a ferrocene direct pass's f-shell class pairs, its launches
those of the ferrocene direct run; ``launches_rhf_ccsd_t`` counts the
benzene RHF + CCSD(T) path, ``launches_rhf_gradient`` the benzene RHF +
gradient path, ``launches_sweep`` the benzene conformer sweep); the last
line is a JSON object naming the device.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
WATER_E = -76.02713907  # water/cc-pVDZ fixed point (diag_rms 1e-10, JAX package on CPU)
BENZENE_E = -230.72299497  # benzene/cc-pVDZ (diag_rms 1e-8, JAX package; noisy to ~1e-7)
BENZENE_E_CARD = -230.7229951380  # the port's benzene/cc-pVDZ value on an H100
# naphthalene/cc-pVDZ, Cartesian, diag_rms 1e-8: a TPU run of the JAX
# package (README), noisy to ~1e-7 as the benzene anchor
NAPHTHALENE_E = -383.37852231
# OH doublet/6-31G fixed point (JAX package on the CPU, tests/test_scf_uhf.py:83)
OH_E = -75.363169916
# water/cc-pVDZ spherical fixed point (diag_rms 1e-10, JAX package on the CPU)
WATER_SPH_E = -76.02679869798291
# naphthalene/cc-pVDZ spherical, diag_rms 1e-8: a TPU run of the JAX package
# (README, docs/PROFILE_r03.md), noisy to ~1e-7 as the Cartesian anchor
NAPHTHALENE_SPH_E = -383.37711111
# water/cc-pVDZ MP2 at the RHF fixed point (diag_rms 1e-10), the JAX
# package's in-core mp2 on the CPU: correlation and total energy
WATER_MP2_CORR = -0.20751927094231992
WATER_MP2_E = -76.23465834212983
# water/cc-pVDZ CCSD(T) at the same fixed point (cc_epsilon 1e-10), the JAX
# package's spatial ccsd on the CPU: CCSD correlation, (T), total (PERF.md §2)
WATER_CCSD_CORR = -0.21651175874440504
WATER_CCSD_T = -0.0032255204357757436
WATER_CCSD_T_E = -76.2468763503677
# naphthalene/cc-pVDZ MP2 (frozen 0) on its pair SCF at diag_rms 1e-10, the
# port's value on an H100 (in core and pair space agree to 1.3e-15)
NAPHTHALENE_MP2_CORR = -1.357088035186
KERNEL1_RTOL = 1e-12
KERNEL3_RTOL = 1e-12
KERNEL2_RTOL = 1e-12
BOYS_RTOL = 1e-14
# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth and FP64
# outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP64_FLOP_PER_S = 34e12


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def rel_err(out: torch.Tensor, ref: torch.Tensor) -> tuple[float, float]:
    """(max abs error, max abs error / max |ref|)."""
    err = float((out - ref).abs().max())
    return err, err / float(ref.abs().max())


def class_name(m1, m2) -> str:
    """A class pair's name, "(ps|fd)", from its two classes' layouts."""
    return "({}{}|{}{})".format(*("spdfghi"[l] for l in (m1.la, m1.lb, m2.la, m2.lb)))


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


def device_ms(fn, reps: int, names: tuple) -> float:
    """Mean device milliseconds per ``fn()`` call of the kernels whose names
    hold one of ``names``: the summed durations of their device events under
    torch.profiler over ``reps`` calls, after one warm-up call (host time
    between the launches does not count)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a trace now and then comes back without device events
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events() if e.device_type == DeviceType.CUDA
                  and any(n in e.name for n in names)]
        if events:
            return sum(e.time_range.elapsed_us() for e in events) / 1e3 / reps
    fail(f"three traces in a row held no device event of {names}")


def print_ptxas(kernel) -> None:
    """Registers, stack frame and spills of every function in a build's
    ptxas report, and the wall time of each nvcc process."""
    name = None
    for line in kernel.ptxas_report.splitlines():
        if line.startswith("# nvcc "):
            print(line[2:], flush=True)
            continue
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            mangled = m.group(1)
            args = ",".join(re.findall(r"Li(\d+)E", mangled))
            base = re.search(r"(eri_bra_tiles_highl_kernel|eri_bra_tiles_kernel|eri_tile_values_row_kernel|"
                             r"eri_tile_values_highl_kernel|"
                             r"eri_tile_values_shared_kernel|boys_probe_kernel|fock_matvec_kernel)", mangled)
            name = f"{base.group(1) if base else mangled}<{args}>"
            continue
        if name and ("stack frame" in line or "Used" in line):
            print(f"ptxas {kernel.source} {name}: {line.replace('ptxas info    :', '').strip()}",
                  flush=True)


def ragged_class(rng, eri_kernel, Lb: int, Lk: int, a: int, c: int, A: int, T1: int, T2: int,
                 zero_rows: int = 1, C: int | None = None):
    """Random bra and ket classes of two tile blocks each, with zero-E
    primitive pairs interleaved (counts 1..a, the last ``zero_rows`` bra
    pairs all zero), compacted as the engine compacts them, on the card:
    (E1, p1, P1, p2, P2), the two classes' counts and the ket class's E2,
    whole (N2, c, C, S2) when C is given, else one entry per primitive
    pair (kernel 1 does not read it)."""
    from qchem_rs_tpu_torch.ops.mcmurchie import nhermite

    N1, N2 = 2 * T1, 2 * T2
    E1 = rng.standard_normal((N1, a, A, nhermite(Lb)))
    E2 = rng.standard_normal((N2, c, 1, 1) if C is None else (N2, c, C, nhermite(Lk)))
    for E, n in ((E1, a), (E2, c)):
        for i in range(E.shape[0]):
            keep = rng.integers(1, n + 1)
            E[i, rng.permutation(n)[: n - keep]] = 0.0
    E1[N1 - zero_rows:] = 0.0
    host1 = (E1, rng.uniform(0.3, 8.0, (N1, a)), rng.standard_normal((N1, a, 3)) * 1.5)
    host2 = (E2, rng.uniform(0.3, 8.0, (N2, c)), rng.standard_normal((N2, c, 3)) * 1.5)
    E1, p1, P1 = eri_kernel.compact_prims(*(torch.tensor(x, device="cuda") for x in host1))
    E2, p2, P2 = eri_kernel.compact_prims(*(torch.tensor(x, device="cuda") for x in host2))
    return (E1, p1, P1, p2, P2), eri_kernel.prim_counts(E1, T1), eri_kernel.prim_counts(E2, T2), E2


def check_kernel1(eri_kernel, ncart) -> tuple[float, float]:
    """Kernel 1 against its twin for every (Lb, Lk) in {0..6}^2 with ragged
    primitive counts, at the benzene tile edge (32), three tiles per call;
    each class must launch its own part (the template for Lb, Lk <= 4, the
    high-L part for the rest). Returns the worst abs error of each part."""
    rng = np.random.default_rng(7)
    prims = [9, 4, 3, 2, 1, 2, 1]
    worst = {eri_kernel.KERNEL: 0.0, eri_kernel.HIGHL_KERNEL: 0.0}
    for Lb in range(eri_kernel.HIGHL_MAX_SIDE + 1):
        for Lk in range(eri_kernel.HIGHL_MAX_SIDE + 1):
            a, c, T = prims[Lb], prims[Lk], 32
            A = max(ncart(Lb - lb) * ncart(lb) for lb in range(Lb // 2 + 1))
            part = eri_kernel.KERNEL if max(Lb, Lk) <= eri_kernel.KERNEL_MAX_SIDE \
                else eri_kernel.HIGHL_KERNEL
            args, bra, ket, _ = ragged_class(rng, eri_kernel, Lb, Lk, a, c, A, T, T)
            ti, tj = np.array([0, T, T]), np.array([T, 0, T])
            before = part.launches
            out = eri_kernel.bra_tiles(Lb, Lk, *args, ti, tj, T, T, bra, ket)
            ref = eri_kernel.bra_tiles_plain(Lb, Lk, *args, ti, tj, T, T, bra, ket)
            torch.cuda.synchronize()
            err, rel = rel_err(out, ref)
            print(f"kernel1 {part.source} Lb={Lb} Lk={Lk} a={a} c={c} A={A} (ragged counts): "
                  f"max rel err {rel:.3e}", flush=True)
            if part.launches != before + 1:
                fail(f"class ({Lb}, {Lk}) did not launch {part.source}")
            if not rel <= KERNEL1_RTOL:
                fail(f"kernel 1 disagrees with its twin at Lb={Lb} Lk={Lk}: {rel:.3e}")
            worst[part] = max(worst[part], err)
    return worst[eri_kernel.KERNEL], worst[eri_kernel.HIGHL_KERNEL]


def check_highl_shapes(eri_kernel, ncart) -> float:
    """The high-L part in every high-L (Lb, Lk) at the shapes of the
    ferrocene build's (xx|ff) class pairs: ket tiles of one pair (T2 = 1),
    bra tiles of 16, a third of the bra rows without a real primitive pair,
    and few enough blocks that the schedule splits the bra loop. Each class
    is launched twice: the two outputs must be bit-identical. Returns the
    worst abs error."""
    rng = np.random.default_rng(8)
    worst = 0.0
    for Lb in range(eri_kernel.HIGHL_MAX_SIDE + 1):
        for Lk in range(eri_kernel.HIGHL_MAX_SIDE + 1):
            if max(Lb, Lk) <= eri_kernel.KERNEL_MAX_SIDE:
                continue
            a, T1, T2 = 6, 16, 1
            A = max(ncart(Lb - lb) * ncart(lb) for lb in range(Lb // 2 + 1))
            args, bra, ket, _ = ragged_class(rng, eri_kernel, Lb, Lk, a, 1, A, T1, T2, zero_rows=11)
            ti, tj = np.array([0, T1, T1]), np.array([T2, 0, T2])
            sc = eri_kernel.highl_schedule(Lb, Lk, a, 1, A, T1, T2, len(ti),
                                           torch.cuda.get_device_properties(0).multi_processor_count)
            out = eri_kernel.bra_tiles(Lb, Lk, *args, ti, tj, T1, T2, bra, ket)
            again = eri_kernel.bra_tiles(Lb, Lk, *args, ti, tj, T1, T2, bra, ket)
            ref = eri_kernel.bra_tiles_plain(Lb, Lk, *args, ti, tj, T1, T2, bra, ket)
            torch.cuda.synchronize()
            err, rel = rel_err(out, ref)
            same = torch.equal(out, again)
            print(f"kernel1 {eri_kernel.HIGHL_KERNEL.source} Lb={Lb} Lk={Lk} T1={T1} T2={T2} a={a} "
                  f"A={A} (11 bra rows without real prims, bra loop over {sc.nsplit} splits): max rel "
                  f"err {rel:.3e}, two launches bit-identical {same}", flush=True)
            if sc.nsplit < 2 or int((bra.n == 0).sum()) < 11:
                fail(f"the ({Lb}, {Lk}) case does not take the split bra loop or the empty rows")
            if not (rel <= KERNEL1_RTOL and same):
                fail(f"the high-L part at T2=1 disagrees with its twin or itself at Lb={Lb} Lk={Lk}")
            worst = max(worst, err)
    return worst


def check_kernel3(eri_kernel, ncart) -> float:
    """Kernel 3 against its twin (``ket_contract`` of ``bra_tiles_plain``)
    for all 25 (Lb, Lk) <= (4, 4) with ragged primitive counts, at the
    largest tile edge (32, four tiles per call) with the largest component
    counts, and with ket tiles of one pair, bra tiles of 16 of which 11
    rows hold no real primitive pair, and the smallest component counts;
    each launched twice, bit-identical. Returns the worst abs error."""
    rng = np.random.default_rng(9)
    prims = [9, 4, 3, 2, 1]
    worst = 0.0
    for Lb in range(eri_kernel.KERNEL_MAX_SIDE + 1):
        for Lk in range(eri_kernel.KERNEL_MAX_SIDE + 1):
            comps = [[ncart(L - lb) * ncart(lb) for lb in range(L // 2 + 1)] for L in (Lb, Lk)]
            for pick, T1, T2, zero_rows in ((max, 32, 32, 1), (min, 16, 1, 11)):
                A, C = pick(comps[0]), pick(comps[1])
                (E1, p1, P1, p2, P2), bra, ket, E2 = ragged_class(
                    rng, eri_kernel, Lb, Lk, prims[Lb], prims[Lk], A, T1, T2, zero_rows, C)
                args = (E1, p1, P1, E2, p2, P2)
                ti, tj = np.array([0, T1, T1, 0]), np.array([T2, 0, T2, 0])
                before = eri_kernel.VALUES_KERNEL.launches
                out = eri_kernel.tile_values(Lb, Lk, *args, ti, tj, T1, T2, bra, ket)
                again = eri_kernel.tile_values(Lb, Lk, *args, ti, tj, T1, T2, bra, ket)
                ref = eri_kernel.tile_values_plain(Lb, Lk, *args, ti, tj, T1, T2, bra, ket)
                torch.cuda.synchronize()
                err, rel = rel_err(out, ref)
                same = torch.equal(out, again)
                print(f"kernel3 Lb={Lb} Lk={Lk} A={A} C={C} T1={T1} T2={T2} (ragged counts, "
                      f"{int((bra.n == 0).sum())} bra pairs without real prims): max rel err "
                      f"{rel:.3e}, two launches bit-identical {same}", flush=True)
                if eri_kernel.VALUES_KERNEL.launches != before + 2:
                    fail(f"class ({Lb}, {Lk}) did not launch kernel 3")
                if not (rel <= KERNEL3_RTOL and same):
                    fail(f"kernel 3 disagrees with its twin or itself at Lb={Lb} Lk={Lk} T2={T2}")
                worst = max(worst, err)
    return worst


def check_values_highl(eri_kernel, ncart) -> float:
    """Kernel 3's high-L part against its twin for all 24 of its (Lb, Lk)
    (a side of 5 or 6) with ragged primitive counts, from both sides, at
    the largest tile edge (32, four tiles per call) with the largest
    component counts, and at the shapes of ferrocene's (xx|ff) class pairs:
    ket tiles of one pair, bra tiles of 16 of which 11 rows hold no real
    primitive pair, and the smallest component counts; each launched twice,
    bit-identical. Returns the worst abs error."""
    rng = np.random.default_rng(10)
    prims = [9, 4, 3, 2, 1, 2, 1]
    part = eri_kernel.VALUES_HIGHL_KERNEL
    worst = 0.0
    for Lb in range(eri_kernel.HIGHL_MAX_SIDE + 1):
        for Lk in range(eri_kernel.HIGHL_MAX_SIDE + 1):
            if max(Lb, Lk) <= eri_kernel.KERNEL_MAX_SIDE:
                continue
            comps = [[ncart(L - lb) * ncart(lb) for lb in range(L // 2 + 1)] for L in (Lb, Lk)]
            for pick, T1, T2, zero_rows in ((max, 32, 32, 1), (min, 16, 1, 11)):
                A, C = pick(comps[0]), pick(comps[1])
                (E1, p1, P1, p2, P2), bra, ket, E2 = ragged_class(
                    rng, eri_kernel, Lb, Lk, prims[Lb], prims[Lk], A, T1, T2, zero_rows, C)
                args = (E1, p1, P1, E2, p2, P2)
                ti, tj = np.array([0, T1, T1, 0]), np.array([T2, 0, T2, 0])
                ref = eri_kernel.tile_values_plain(Lb, Lk, *args, ti, tj, T1, T2, bra, ket)
                for trans in (False, True):
                    before = part.launches
                    out = eri_kernel.tile_values(Lb, Lk, *args, ti, tj, T1, T2, bra, ket, trans=trans)
                    again = eri_kernel.tile_values(Lb, Lk, *args, ti, tj, T1, T2, bra, ket,
                                                   trans=trans)
                    torch.cuda.synchronize()
                    err, rel = rel_err(out, ref)
                    same = torch.equal(out, again)
                    print(f"kernel3 {part.source} Lb={Lb} Lk={Lk} A={A} C={C} T1={T1} T2={T2} from "
                          f"its {'ket' if trans else 'bra'} side (ragged counts, "
                          f"{int((bra.n == 0).sum())} bra pairs without real prims): max rel err "
                          f"{rel:.3e}, two launches bit-identical {same}", flush=True)
                    if part.launches != before + 2:
                        fail(f"class ({Lb}, {Lk}) did not launch kernel 3's high-L part")
                    if not (rel <= KERNEL3_RTOL and same):
                        fail(f"kernel 3's high-L part disagrees with its twin or itself at Lb={Lb} "
                             f"Lk={Lk} T2={T2} trans={trans}")
                    worst = max(worst, err)
    return worst


def check_boys(eri_kernel) -> None:
    """The kernel's device Boys function against ``boys`` over T in [0, 50]."""
    from qchem_rs_tpu_torch.ops.boys import boys

    T = torch.linspace(0.0, 50.0, 100001, dtype=torch.float64, device="cuda")
    for M in range(eri_kernel.KERNEL_MAX_L + 1):
        ref = boys(M, T)
        rel = float(((eri_kernel.boys_on_card(M, T) - ref).abs() / ref.abs()).max())
        print(f"kernel1 Boys F_0..F_{M}, T in [0, 50]: max rel err {rel:.3e}", flush=True)
        if not rel <= BOYS_RTOL:
            fail(f"the kernel's Boys function misses boys at m <= {M}: {rel:.3e}")


def check_kernel2(fock_matvec) -> dict:
    """Kernel 2 against terms @ d at m = 150, 14400 (benzene/cc-pVDZ, n = 120)
    and 14401 (odd); times the kernel, its twin and the library call (the
    same terms @ d) at m = 14400, in turns."""
    worst_abs = 0.0
    gen = torch.Generator(device="cuda").manual_seed(0)
    timed = None
    for m in (150, 14401, 14400):
        T = torch.randn((m, m), generator=gen, dtype=torch.float64, device="cuda")
        T = T + T.T
        d = torch.randn(m, generator=gen, dtype=torch.float64, device="cuda")
        out = fock_matvec.matvec(T, d)
        again = fock_matvec.matvec(T, d)
        ref = fock_matvec.matvec_plain(T, d)
        torch.cuda.synchronize()
        err, rel = rel_err(out, ref)
        same = torch.equal(out, again)
        print(f"kernel2 m={m}: max rel err {rel:.3e}, two launches bit-identical {same}", flush=True)
        if not rel <= KERNEL2_RTOL:
            fail(f"kernel 2 disagrees with its twin at m={m}: {rel:.3e}")
        if not same:
            fail(f"two launches of kernel 2 at m={m} differ")
        worst_abs = max(worst_abs, err)
        timed = (m, T, d) if m == 14400 else None
        if timed is None:
            del T
    m, T, d = timed
    ms, plain_ms, library_ms = [], [], []
    for _ in range(2):
        library_ms.append(cuda_ms(lambda: T @ d, 50))
        ms.append(cuda_ms(lambda: fock_matvec.matvec(T, d), 50))
        plain_ms.append(cuda_ms(lambda: fock_matvec.matvec_plain(T, d), 50))
    nb = -(-m // fock_matvec.BLOCK)
    nbytes = 8.0 * (nb * (nb + 1) // 2 * fock_matvec.BLOCK**2 + 2 * m)  # upper blocks, d, G
    res = {"max_abs_err": worst_abs, "ms": float(np.mean(ms)), "plain_ms": float(np.mean(plain_ms)),
           "library_ms": float(np.mean(library_ms)), "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
           "bound_by": "bytes"}
    print(f"kernel2 m={m}: {res['ms']:.4f} ms ({nbytes / (res['ms'] * 1e-3) / 1e9:.0f} GB/s of the "
          f"{nbytes / 1e9:.3f} GB it must read), twin {res['plain_ms']:.4f} ms, terms @ d "
          f"{res['library_ms']:.4f} ms, bound {res['bound_ms']:.4f} ms "
          f"(runs: kernel {ms}, terms @ d {library_ms})", flush=True)
    del T
    return res


def load_system(Q, mol: str, basis: str = "cc-pVDZ", spherical: bool = False):
    basis = Q.BasisSet.load(os.path.join(ROOT, "data", "basis", f"{basis}.json"))
    return Q.MolecularSystem.load(os.path.join(ROOT, "data", "mol", f"{mol}.json"), basis,
                                  spherical=spherical)


def run_rhf(Q, mol: str, eps: float, max_iterations: int, spherical: bool = False):
    system = load_system(Q, mol, spherical=spherical)
    cfg = Q.HartreeFockConfig(epsilon=eps, max_iterations=max_iterations)
    t0 = time.perf_counter()
    out = Q.restricted_hartree_fock(system, cfg, device="cuda")
    wall = time.perf_counter() - t0
    return system, cfg, out, wall


def time_kernel1(engine, eri_kernel) -> dict:
    """Kernel 1 against its twin over every tile batch of one benzene build,
    then the whole build's time: kernel, twin (in its own smaller batches:
    its R tables are larger than the kernel's output) and bound."""
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
    ms = [cuda_ms(lambda: [engine.bra_batch(*b) for b in kernel_batches], 5) for _ in range(2)]
    plain_ms = cuda_ms(
        lambda: [engine.bra_batch(*b, fn=eri_kernel.bra_tiles_plain) for b in twin_batches], 1
    )
    nbytes, flops = engine.bra_kernel_work()
    bytes_ms, flops_ms = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP64_FLOP_PER_S * 1e3
    res = {"max_abs_err": worst_abs, "ms": float(np.mean(ms)), "plain_ms": plain_ms,
           "library_ms": None, "bound_ms": max(bytes_ms, flops_ms),
           "bound_by": "bytes" if bytes_ms >= flops_ms else "operations"}
    print(f"kernel1 benzene build ({len(kernel_batches)} launches): {res['ms']:.3f} ms "
          f"(runs {ms}), twin {plain_ms:.3f} ms, max abs err {worst_abs:.3e}; must move "
          f"{nbytes / 1e9:.3f} GB ({bytes_ms:.4f} ms) and do {flops / 1e9:.2f} GFLOP over the real "
          f"primitive quartets ({flops_ms:.4f} ms): bound {res['bound_ms']:.4f} ms by "
          f"{res['bound_by']}", flush=True)
    return res


def time_engine_setup(system) -> None:
    """Host time of the tiled engine's set-up on the card, and of the part
    of it that orders primitive pairs and counts them for kernel 1."""
    from qchem_rs_tpu_torch.ops.eri_kernel import compact_prims, prim_counts
    from qchem_rs_tpu_torch.ops.eri_tiled import TiledEriEngine, pad_group

    runs = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine = TiledEriEngine(system, 1e-12, device="cuda")
        torch.cuda.synchronize()
        runs.append(time.perf_counter() - t0)
    padded = [pad_group(g, m.npad) for g, m in zip(engine.layout.groups, engine.layout.metas)]
    compact = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for (E, p, P), m in zip(padded, engine.layout.metas):
            prim_counts(compact_prims(E, p, P)[0], m.tile)
        torch.cuda.synchronize()
        compact.append(time.perf_counter() - t0)
    print(f"benzene engine setup: {', '.join(f'{t:.4f}' for t in runs)} s; of which primitive "
          f"compaction and counts {', '.join(f'{t:.4f}' for t in compact)} s", flush=True)


def device_profile(label: str, fn) -> None:
    """torch.profiler over one call of ``fn``: device time by kernel and the
    busy share of the profiled wall time. Only the device's own events
    (kernels, copies, memsets) count: the device time of an aten row is that
    of the kernels beneath it, which are events of their own. The busy time
    is the union of their intervals, so kernels that overlap count once."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not events:
        print(f"profile {label}: the profiler traced no device events: busy share not measured",
              flush=True)
        return
    busy_us, end = 0.0, float("-inf")
    for start, stop in sorted((e.time_range.start, e.time_range.end) for e in events):
        if stop > end:
            busy_us += stop - max(start, end)
            end = stop
    by_name: dict[str, list] = {}
    for e in events:
        row = by_name.setdefault(e.name, [0.0, 0])
        row[0] += e.time_range.elapsed_us()
        row[1] += 1
    summed_us = sum(us for us, _ in by_name.values())
    total = f" (total_s {out.timings['total_s']:.4f})" if hasattr(out, "timings") else ""
    print(f"profile {label}: wall {wall:.4f} s{total}, {len(events)} device events summing to "
          f"{summed_us / 1e6:.4f} s, busy (their union) {busy_us / 1e6:.4f} s, busy share "
          f"{busy_us / 1e6 / wall:.4f}", flush=True)
    for name, (us, count) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]:
        print(f"profile {label}: {us / 1e3:10.3f} ms {count:6d}x {name[:90]}", flush=True)


def launches_of(kernels: dict) -> dict:
    return {name: k.launches for name, k in kernels.items()}


def reset(kernels: dict) -> None:
    for k in kernels.values():
        k.launches = 0


def drive(kernels: dict, label: str, fn, used: tuple, budget=None):
    """Run ``fn()`` once with every launch count set to 0 just before and
    read just after, the peak device memory reset before; fail if a kernel
    in ``used`` was not launched. ``budget`` sets the pair builder's byte
    budget for the run. Returns (output, launches, peak bytes, wall s)."""
    from qchem_rs_tpu_torch.ops.fock_pair import BUDGET_ENV

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    old = os.environ.get(BUDGET_ENV)
    if budget is not None:
        os.environ[BUDGET_ENV] = str(budget)
    reset(kernels)
    try:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        if budget is not None:
            os.environ.pop(BUDGET_ENV)
            if old is not None:
                os.environ[BUDGET_ENV] = old
    launches = launches_of(kernels)
    peak = torch.cuda.max_memory_allocated()
    timings = ", ".join(f"{k} {v:.4f}" for k, v in out.timings.items())
    print(f"{label}: E {out.total_energy():.10f}, {out.iterations} iterations, converged "
          f"{out.converged}, wall {wall:.4f} s; timings: {timings}; peak device memory "
          f"{peak / 1e9:.3f} GB; launches {launches}", flush=True)
    if not out.converged:
        fail(f"{label} did not converge")
    missing = [name for name in used if launches[name] == 0]
    if missing:
        fail(f"{label} bypassed {missing}: {launches}")
    if "eri_tile_values" in used and launches.get("eri_tile_highl", 0):
        fail(f"{label}, a direct path, launched kernel 1's high-L part: {launches}")
    return out, launches, peak, wall


def check_repeat(label: str, a, b) -> None:
    """Fail unless two runs on the same inputs gave the same energy bits,
    density bits and iteration count."""
    energy = a.electronic_energy == b.electronic_energy
    density = bool(np.array_equal(a.density, b.density))
    print(f"{label} twice: energy bits equal {energy}, density bits equal {density}, iterations "
          f"{a.iterations} and {b.iterations}", flush=True)
    if not (energy and density and a.iterations == b.iterations):
        fail(f"two {label} runs on the same inputs differ")


def naphthalene_rhf(Q, kernels: dict, paths: dict):
    """RHF on naphthalene/cc-pVDZ through every Fock mode (SAD guess) and
    the pair mode from the Hückel guess, and the pair and direct SAD runs
    repeated (equal bits). Returns the system and the SAD pair run's
    output."""
    from qchem_rs_tpu_torch.ops.eri_tiled import TiledEriEngine

    basis = Q.BasisSet.load(os.path.join(ROOT, "data", "basis", "cc-pVDZ.json"))
    system = Q.MolecularSystem.load(os.path.join(ROOT, "data", "mol", "naphthalene.json"), basis)
    M, nao = TiledEriEngine(system, 1e-12, device="cuda").layout.M, system.n_basis()
    both = ("eri_tile", "fock_matvec")
    runs = {}
    for label, mode, guess, budget, used in (
        ("incore sad", "incore", "sad", None, both),
        ("pair sad", "pair", "sad", None, both),
        ("pair lean sad", "pair", "sad", 0, both),
        ("direct sad", "direct", "sad", None, ("eri_tile_values",)),
        ("pair huckel", "pair", "huckel", None, both),
    ):
        cfg = Q.HartreeFockConfig(epsilon=1e-8, max_iterations=150, fock_mode=mode,
                                  initial_guess=guess)
        out, launches, peak, wall = drive(
            kernels, f"naphthalene/cc-pVDZ {label}",
            lambda: Q.restricted_hartree_fock(system, cfg, device="cuda"), used, budget)
        runs[label] = out
        paths[f"rhf naphthalene {label}"] = dict(launches, iterations=out.iterations,
                                                 peak_bytes=peak, total_s=out.timings["total_s"])
        dE = out.total_energy() - NAPHTHALENE_E
        print(f"naphthalene/cc-pVDZ {label}: dE {dE:.2e} from the anchor", flush=True)
        if abs(dE) > 1e-6:
            fail(f"naphthalene/cc-pVDZ {label} lies {dE:.2e} Eh from its anchor")
    v2_bytes, pair_bytes = 8.0 * M * M, 8.0 * (M * M + nao * nao * M)
    print(f"naphthalene/cc-pVDZ: M {M}, nao {nao}; V2 {v2_bytes / 1e9:.3f} GB, V2f + W "
          f"{pair_bytes / 1e9:.3f} GB", flush=True)
    if paths["rhf naphthalene direct sad"]["peak_bytes"] >= v2_bytes:
        fail("the direct mode's peak reaches the size of V2")
    if paths["rhf naphthalene pair lean sad"]["peak_bytes"] >= pair_bytes:
        fail("the lean pair run holds as much as V2f and W")
    # the pair and direct SAD runs again: the same bits
    for label in ("pair sad", "direct sad"):
        mode = label.split()[0]
        cfg = Q.HartreeFockConfig(epsilon=1e-8, max_iterations=150, fock_mode=mode,
                                  initial_guess="sad")
        again, _, _, _ = drive(
            kernels, f"naphthalene/cc-pVDZ {label} again",
            lambda: Q.restricted_hartree_fock(system, cfg, device="cuda"),
            both if mode == "pair" else ("eri_tile_values",))
        check_repeat(f"naphthalene/cc-pVDZ {label}", runs[label], again)
    sad = [o.total_energy() for label, o in runs.items() if label.endswith("sad")]
    print(f"naphthalene/cc-pVDZ SAD modes: spread {max(sad) - min(sad):.2e} Eh; pair iterations "
          f"SAD {runs['pair sad'].iterations}, Hückel {runs['pair huckel'].iterations}", flush=True)
    if max(sad) - min(sad) > 1e-7:
        fail("naphthalene/cc-pVDZ SAD runs disagree by more than 1e-7 Eh")
    return system, runs["pair sad"]


def pair_kernel_numbers(system, density, fock_matvec) -> dict:
    """Kernel 2 on the mirrored V2f of naphthalene against its twin, its
    bound and torch.mv, and W @ dK against its bound, at the converged
    density's vectors."""
    from qchem_rs_tpu_torch.ops.fock_pair import PairSpaceFockBuilder

    builder = PairSpaceFockBuilder(system, 1e-12, device="cuda", lean=False)
    V2f, W = builder.prepare()
    dJ, dK = builder.density_vectors(torch.tensor(density, device="cuda"))
    m = V2f.shape[0]
    out, ref = fock_matvec.matvec(V2f, dJ), fock_matvec.matvec_plain(V2f, dJ)
    again = fock_matvec.matvec(V2f, dJ)
    torch.cuda.synchronize()
    err, rel = rel_err(out, ref)
    if not rel <= KERNEL2_RTOL:
        fail(f"kernel 2 disagrees with its twin on V2f at m={m}: {rel:.3e}")
    if not torch.equal(out, again):
        fail(f"two launches of kernel 2 on V2f at m={m} differ")
    print(f"kernel2 on naphthalene V2f m={m}: two launches bit-identical", flush=True)
    ms, plain_ms, mv_ms, w_ms = [], [], [], []
    for _ in range(2):
        mv_ms.append(cuda_ms(lambda: torch.mv(V2f, dJ), 20))
        ms.append(cuda_ms(lambda: fock_matvec.matvec(V2f, dJ), 20))
        plain_ms.append(cuda_ms(lambda: fock_matvec.matvec_plain(V2f, dJ), 20))
        w_ms.append(cuda_ms(lambda: torch.mv(W, dK), 20))
    nb = -(-m // fock_matvec.BLOCK)
    nbytes = 8.0 * (nb * (nb + 1) // 2 * fock_matvec.BLOCK**2 + 2 * m)
    w_bytes = 8.0 * (W.numel() + W.shape[0] + W.shape[1])
    res = {"m": m, "max_abs_err": err, "rel_err": rel, "ms": float(np.mean(ms)),
           "plain_ms": float(np.mean(plain_ms)), "library_ms": float(np.mean(mv_ms)),
           "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "w_ms": float(np.mean(w_ms)),
           "w_bound_ms": w_bytes / HBM_BYTES_PER_S * 1e3}
    print(f"kernel2 on naphthalene V2f m={m}: {res['ms']:.4f} ms (runs {ms}), twin "
          f"{res['plain_ms']:.4f} ms, torch.mv {res['library_ms']:.4f} ms, bound "
          f"{res['bound_ms']:.4f} ms ({nbytes / 1e9:.3f} GB block upper triangle); max rel err "
          f"{rel:.3e}", flush=True)
    print(f"W @ dK on naphthalene ({W.shape[0]} x {W.shape[1]}): {res['w_ms']:.4f} ms (runs "
          f"{w_ms}), bound {res['w_bound_ms']:.4f} ms ({w_bytes / 1e9:.3f} GB)", flush=True)
    return res


def direct_pass_numbers(system, density, eri_kernel, profile: bool = False) -> dict:
    """Per direct pass on naphthalene: kernel 3 against its twin on the
    first twin-sized batch of every class pair, its launches over one pass
    counted, two passes equal in bits; then, in turns in this run, kernel 3
    over the pass's batches and the old route over the same tiles (kernel 1
    in its own batches, then ``ket_contract``), kernel 3's twin, the whole
    J/K pass (the digestion is the difference), kernel 3's bound, and the
    five class pairs that take the most kernel-3 time."""
    from qchem_rs_tpu_torch.ops.eri_kernel import ket_contract
    from qchem_rs_tpu_torch.ops.fock_stream import StreamingFockBuilder

    builder = StreamingFockBuilder(system, 1e-12, device="cuda")
    eng = builder.engine
    metas = eng.layout.metas
    worst, seen = 0.0, set()
    for i1, i2, ti, tj in eng.batches(twin=True):
        if (i1, i2) in seen:
            continue
        seen.add((i1, i2))
        out = eng.values_batch(i1, i2, ti, tj)
        ref = eng.values_batch(i1, i2, ti, tj, fn=eri_kernel.tile_values_plain)
        err, rel = rel_err(out, ref)
        if not rel <= KERNEL3_RTOL:
            fail(f"kernel 3 disagrees with its twin on naphthalene class pair {i1},{i2}: {rel:.3e}")
        worst = max(worst, err)
    D = torch.tensor(density, device="cuda")[None]
    old_batches = list(eng.batches(values=False))  # kernel 1's batches of the same tiles

    def values(ks=range(len(builder.batches))):
        for k in ks:
            builder.tile_values(k)

    def old():
        for i1, i2, ti, tj in old_batches:
            ket_contract(eng.bra_batch(i1, i2, ti, tj), eng._padded[i2][0], tj, metas[i2].tile)

    def plain():  # the twin over the same tiles, in its own batch sizes
        for i1, i2, ti, tj in eng.batches(twin=True):
            eng.values_batch(i1, i2, ti, tj, fn=eri_kernel.tile_values_plain)

    before = eri_kernel.VALUES_KERNEL.launches, eri_kernel.KERNEL.launches
    J1, K1 = builder.jk_stack_cart(D)
    torch.cuda.synchronize()
    per_pass = eri_kernel.VALUES_KERNEL.launches - before[0]
    k1_per_pass = eri_kernel.KERNEL.launches - before[1]
    J2, K2 = builder.jk_stack_cart(D)
    same = torch.equal(J1, J2) and torch.equal(K1, K2)
    print(f"direct pass on naphthalene twice: J and K bit-identical {same}", flush=True)
    if not same:
        fail("two direct passes on the same naphthalene density differ")
    if per_pass != len(builder.batches) or k1_per_pass:
        fail(f"a direct pass launched kernel 3 {per_pass} times and kernel 1 {k1_per_pass} times, "
             f"not {len(builder.batches)} and 0")
    kv, ko, full = [], [], []
    for _ in range(2):  # in turns: kernel 3, old route, old route, kernel 3
        kv.append(cuda_ms(values, 2))
        ko.append(cuda_ms(old, 2))
        ko.append(cuda_ms(old, 2))
        kv.append(cuda_ms(values, 2))
        full.append(cuda_ms(lambda: builder.jk_stack_cart(D), 2))
    plain_ms = cuda_ms(plain, 1)
    nbytes, flops = eng.values_kernel_work()
    bytes_ms, flops_ms = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP64_FLOP_PER_S * 1e3
    res = {"launches_per_pass": per_pass, "max_abs_err": worst, "ms": float(np.mean(kv)),
           "old_route_ms": float(np.mean(ko)), "plain_ms": plain_ms,
           "digest_ms": float(np.mean(full) - np.mean(kv)), "pass_ms": float(np.mean(full)),
           "bound_ms": max(bytes_ms, flops_ms), "library_ms": None,
           "bound_by": "bytes" if bytes_ms >= flops_ms else "operations"}
    print(f"direct pass on naphthalene: {per_pass} kernel-3 launches ({len(old_batches)} for kernel "
          f"1 in its own batches); kernel 3 {res['ms']:.3f} ms (runs {kv}), old route kernel 1 + "
          f"ket_contract over the same tiles {res['old_route_ms']:.3f} ms (runs {ko}), kernel 3's "
          f"twin {plain_ms:.3f} ms; digestion {res['digest_ms']:.3f} ms, whole pass "
          f"{res['pass_ms']:.3f} ms (runs {full}); kernel 3 must move {nbytes / 1e9:.3f} GB "
          f"({bytes_ms:.4f} ms) and do {flops / 1e9:.2f} GFLOP ({flops_ms:.4f} ms): bound "
          f"{res['bound_ms']:.4f} ms by {res['bound_by']}; kernel 3 vs twin max abs err "
          f"{worst:.3e} over {len(seen)} class pairs", flush=True)
    if not res["ms"] < res["old_route_ms"]:
        fail("kernel 3 is not faster than kernel 1 + ket_contract over the same tiles")
    by_class: dict = {}
    for k, (i1, i2, _, _) in enumerate(builder.batches):
        by_class.setdefault((i1, i2), []).append(k)
    rows = []
    for (i1, i2), ks in by_class.items():
        m1, m2 = metas[i1], metas[i2]
        ms = cuda_ms(lambda: values(ks), 3)
        cb, cf = eng.values_kernel_work(pairs={(i1, i2)})
        rows.append((ms, class_name(m1, m2), len(ks),
                     max(cb / HBM_BYTES_PER_S, cf / FP64_FLOP_PER_S) * 1e3, cf))
    summed = sum(r[0] for r in rows)
    for ms, name, n, bound, cf in sorted(rows, reverse=True)[:5]:
        print(f"kernel 3 class {name}: {ms:.4f} ms ({ms / summed:.3f} of the class pairs' sum "
              f"{summed:.3f} ms), {n} launches, own bound {bound:.4f} ms ({cf / 1e9:.3f} GFLOP), "
              f"time/bound {ms / bound:.1f}", flush=True)
    if profile:
        device_profile("naphthalene direct pass", lambda: builder.jk_stack_cart(D))
        batch_sweep(system, D, eng)
    return res


def batch_sweep(system, D, engine) -> None:
    """One direct pass at three batch sizes (the engine's BATCH_BYTES is
    the largest): time and peak device memory."""
    from qchem_rs_tpu_torch.ops import eri_tiled
    from qchem_rs_tpu_torch.ops.fock_stream import StreamingFockBuilder

    default = eri_tiled.BATCH_BYTES
    try:
        for shift in (27, 28, 29):
            eri_tiled.BATCH_BYTES = 1 << shift
            builder = StreamingFockBuilder(system, 1e-12, device="cuda", engine=engine)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            runs = [cuda_ms(lambda: builder.jk_stack_cart(D), 2) for _ in range(2)]
            print(f"direct pass with 2^{shift}-byte batches ({len(builder.batches)} launches): "
                  f"{np.mean(runs):.3f} ms (runs {runs}), peak device memory "
                  f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB", flush=True)
    finally:
        eri_tiled.BATCH_BYTES = default


def uhf_6_31g(Q, kernels: dict, paths: dict) -> None:
    """UHF at BASELINE config 3: OH doublet and O2 triplet in 6-31G
    through the three Fock modes at diag_rms 1e-12. UHF's diag_rms stop (the
    spin mean of the diagonal RMS, halved) can end OH's oscillating DIIS
    tail at a dip: at 1e-10 a direct run stopped 1.04e-8 Eh from the fixed
    point, and with sums in a fixed order such a stop repeats on every run;
    at 1e-12 the modes agree within 1e-13 on the CPU."""
    basis = Q.BasisSet.load(os.path.join(ROOT, "data", "basis", "6-31G.json"))
    for mol, mult in (("hydroxyl", 2), ("oxygen", 3)):
        system = Q.MolecularSystem.load(os.path.join(ROOT, "data", "mol", f"{mol}.json"), basis)
        energies = []
        for mode in ("incore", "pair", "direct"):
            cfg = Q.HartreeFockConfig(epsilon=1e-12, max_iterations=500, spin_multiplicity=mult,
                                      fock_mode=mode)
            used = ("eri_tile_values",) if mode == "direct" else ("eri_tile", "fock_matvec")
            out, launches, peak, _ = drive(
                kernels, f"UHF {mol}/6-31G multiplicity {mult} {mode}",
                lambda: Q.unrestricted_hartree_fock(system, cfg, device="cuda"), used)
            paths[f"uhf {mol} {mode}"] = dict(launches, iterations=out.iterations,
                                              peak_bytes=peak, total_s=out.timings["total_s"])
            energies.append(out.total_energy())
        if mol == "hydroxyl":
            dE = max(abs(e - OH_E) for e in energies)
            print(f"UHF OH/6-31G: largest |dE| {dE:.2e} from the CPU fixed point", flush=True)
            if dE > 1e-8:
                fail(f"UHF OH/6-31G lies {dE:.2e} Eh from its fixed point")
        else:
            spread = max(energies) - min(energies)
            print(f"UHF O2/6-31G triplet: spread {spread:.2e} Eh over the modes", flush=True)
            if spread > 1e-8 or not all(-149.8 < e < -149.3 for e in energies):
                fail(f"UHF O2/6-31G triplet energies {energies} disagree or leave (-149.8, -149.3)")


def naphthalene_spherical(Q, kernels: dict, paths: dict) -> None:
    """RHF on naphthalene/cc-pVDZ in spherical AOs (180) from the SAD guess
    through the three Fock modes, each against the spherical anchor and
    the three against each other."""
    system = load_system(Q, "naphthalene", spherical=True)
    both = ("eri_tile", "fock_matvec")
    energies = []
    for mode, used in (("incore", both), ("pair", both), ("direct", ("eri_tile_values",))):
        cfg = Q.HartreeFockConfig(epsilon=1e-8, max_iterations=150, fock_mode=mode,
                                  initial_guess="sad")
        label = f"naphthalene/cc-pVDZ spherical {mode} sad"
        out, launches, peak, _ = drive(
            kernels, label, lambda: Q.restricted_hartree_fock(system, cfg, device="cuda"), used)
        paths[f"rhf naphthalene spherical {mode} sad"] = dict(
            launches, iterations=out.iterations, peak_bytes=peak, total_s=out.timings["total_s"])
        dE = out.total_energy() - NAPHTHALENE_SPH_E
        print(f"{label}: dE {dE:.2e} from the anchor", flush=True)
        if abs(dE) > 1e-6:
            fail(f"{label} lies {dE:.2e} Eh from its anchor")
        energies.append(out.total_energy())
    spread = max(energies) - min(energies)
    print(f"naphthalene/cc-pVDZ spherical: {system.n_basis()} AOs, spread {spread:.2e} Eh over the "
          f"modes", flush=True)
    if spread > 1e-7:
        fail("naphthalene/cc-pVDZ spherical modes disagree by more than 1e-7 Eh")


def uhf_spherical(Q, kernels: dict, paths: dict) -> None:
    """UHF on the OH doublet in spherical 6-31G* through the three modes at
    diag_rms 1e-12 (as ``uhf_6_31g``); they must agree within 1e-8."""
    system = load_system(Q, "hydroxyl", "6-31G_st", spherical=True)
    energies = []
    for mode in ("incore", "pair", "direct"):
        cfg = Q.HartreeFockConfig(epsilon=1e-12, max_iterations=500, spin_multiplicity=2,
                                  fock_mode=mode)
        used = ("eri_tile_values",) if mode == "direct" else ("eri_tile", "fock_matvec")
        out, launches, peak, _ = drive(
            kernels, f"UHF hydroxyl/6-31G* spherical {mode}",
            lambda: Q.unrestricted_hartree_fock(system, cfg, device="cuda"), used)
        paths[f"uhf hydroxyl spherical {mode}"] = dict(
            launches, iterations=out.iterations, peak_bytes=peak, total_s=out.timings["total_s"])
        energies.append(out.total_energy())
    spread = max(energies) - min(energies)
    print(f"UHF OH/6-31G* spherical: spread {spread:.2e} Eh over the modes", flush=True)
    if spread > 1e-8:
        fail(f"UHF OH/6-31G* spherical modes disagree: {energies}")


def ferrocene(Q, kernels: dict, paths: dict):
    """RHF on ferrocene/6-31G* (Cartesian, 209 AOs, an f shell on Fe) from
    the SAD guess through the three Fock modes: every build and direct pass
    runs kernel 1's high-L part, every direct pass kernel 3's. Returns the
    system, the in-core run's launches and the pair run."""
    system = load_system(Q, "ferrocene", "6-31G_st")
    hl = ("eri_tile", "eri_tile_highl")
    energies, incore, pair = [], None, None
    for mode, used in (("incore", hl + ("fock_matvec",)), ("pair", hl + ("fock_matvec",)),
                       ("direct", ("eri_tile_values", "eri_tile_values_highl"))):
        cfg = Q.HartreeFockConfig(epsilon=1e-8, max_iterations=200, fock_mode=mode,
                                  initial_guess="sad")
        out, launches, peak, _ = drive(
            kernels, f"ferrocene/6-31G* {mode} sad",
            lambda: Q.restricted_hartree_fock(system, cfg, device="cuda"), used)
        paths[f"rhf ferrocene {mode} sad"] = dict(
            launches, iterations=out.iterations, peak_bytes=peak, total_s=out.timings["total_s"])
        energies.append(out.total_energy())
        incore = launches if mode == "incore" else incore
        pair = out if mode == "pair" else pair
    spread = max(energies) - min(energies)
    print(f"ferrocene/6-31G*: {system.n_basis()} AOs, E {energies[0]:.10f}, spread {spread:.2e} Eh "
          f"over the modes", flush=True)
    if spread > 1e-7:
        fail(f"ferrocene/6-31G* modes disagree: {energies}")
    return system, incore, pair


def class_shape(engine, batch, sms: int) -> tuple:
    """``highl_schedule``'s arguments for one kernel-1 batch of the engine."""
    i1, i2, ti, _ = batch
    m1, m2 = engine.layout.metas[i1], engine.layout.metas[i2]
    return (m1.la + m1.lb, m2.la + m2.lb, m1.a, m2.a, m1.A, m1.tile, m2.tile, len(ti), sms)


def time_highl(system, eri_kernel) -> dict:
    """The high-L part on the f-shell class pairs of one ferrocene build:
    against its twin on every twin-sized batch, then its time as every
    kernel of the kernels line is timed (CUDA events around the calls, host
    included: ``ms``) and its kernels' device time (torch.profiler:
    ``device_ms``), in all and by class pair beside each class's own bound,
    the twin's time and the bound of the whole work."""
    from qchem_rs_tpu_torch.ops.eri_tiled import TiledEriEngine

    engine = TiledEriEngine(system, 1e-12, device="cuda")
    metas = engine.layout.metas

    def highl(Lb, Lk):
        return max(Lb, Lk) > eri_kernel.KERNEL_MAX_SIDE

    def of(batches):
        return [b for b in batches
                if highl(metas[b[0]].la + metas[b[0]].lb, metas[b[1]].la + metas[b[1]].lb)]

    kernel_batches, twin_batches = of(engine.batches()), of(engine.batches(twin=True))
    worst = 0.0
    for b in twin_batches:
        out, ref = engine.bra_batch(*b), engine.bra_batch(*b, fn=eri_kernel.bra_tiles_plain)
        err, rel = rel_err(out, ref)
        if not rel <= KERNEL1_RTOL:
            fail(f"the high-L part disagrees with its twin on ferrocene class pair {b[:2]}: {rel:.3e}")
        worst = max(worst, err)
    kernel_names = ("highl",)  # the part's zero, tile and reduce kernels
    before = eri_kernel.HIGHL_KERNEL.launches
    ms = [cuda_ms(lambda: [engine.bra_batch(*b) for b in kernel_batches], 5) for _ in range(2)]
    dev_ms = [device_ms(lambda: [engine.bra_batch(*b) for b in kernel_batches], 5, kernel_names)
              for _ in range(2)]
    plain_ms = cuda_ms(
        lambda: [engine.bra_batch(*b, fn=eri_kernel.bra_tiles_plain) for b in twin_batches], 1)
    if eri_kernel.HIGHL_KERNEL.launches == before:
        fail("the ferrocene build's f-shell class pairs did not launch the high-L part")
    by_class: dict = {}
    for b in kernel_batches:
        by_class.setdefault(class_name(metas[b[0]], metas[b[1]]), []).append(b)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = []
    for k, bs in by_class.items():
        calls = cuda_ms(lambda: [engine.bra_batch(*b) for b in bs], 3)
        dev = device_ms(lambda: [engine.bra_batch(*b) for b in bs], 3, kernel_names)
        cb, cf = engine.bra_kernel_work(pairs={b[:2] for b in bs})
        bound = max(cb / HBM_BYTES_PER_S, cf / FP64_FLOP_PER_S) * 1e3
        rows.append((calls, k, dev, bound, cb, cf,
                     eri_kernel.highl_schedule(*class_shape(engine, bs[0], sms))))
    summed = sum(r[0] for r in rows)
    for calls, k, dev, bound, cb, cf, sched in sorted(rows, reverse=True):
        print(f"high-L class {k}: {calls:.4f} ms ({calls / summed:.3f} of the classes' sum), own "
              f"bound {bound:.4f} ms ({cb / 1e9:.4f} GB, {cf / 1e9:.4f} GFLOP), time/bound "
              f"{calls / bound:.1f}; device {dev:.4f} ms, device/bound {dev / bound:.1f}; {sched}",
              flush=True)
    nbytes, flops = engine.bra_kernel_work(highl)
    bytes_ms, flops_ms = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP64_FLOP_PER_S * 1e3
    res = {"max_abs_err": worst, "ms": float(np.mean(ms)), "device_ms": float(np.mean(dev_ms)),
           "plain_ms": plain_ms, "library_ms": None, "bound_ms": max(bytes_ms, flops_ms),
           "bound_by": "bytes" if bytes_ms >= flops_ms else "operations"}
    print(f"high-L part over the ferrocene build's f-shell class pairs ({len(kernel_batches)} "
          f"launches): {res['ms']:.4f} ms (CUDA events around the calls, runs {ms}); its kernels on "
          f"the device {res['device_ms']:.4f} ms (torch.profiler, runs {dev_ms}); twin "
          f"{plain_ms:.3f} ms, max abs err {worst:.3e}; must move {nbytes / 1e9:.3f} GB "
          f"({bytes_ms:.4f} ms) and do {flops / 1e9:.2f} GFLOP over the real primitive quartets "
          f"({flops_ms:.4f} ms): bound {res['bound_ms']:.4f} ms by {res['bound_by']}", flush=True)
    return res


def ferrocene_direct_numbers(system, density, eri_kernel) -> dict:
    """Kernel 3's high-L part on the f-shell class pairs of one ferrocene
    direct pass, at the pair SCF's density: against its twin on every
    twin-sized batch, relaunched in equal bits; one pass's launches (kernel
    3's two parts, kernel 1 none) and two passes equal in bits; then, in
    turns in this run, the new part over the pass's f-shell batches and the
    old route over the same tiles (kernel 1's high-L part in its own
    batches, then ``ket_contract``), the twin, the bound
    (``values_kernel_work`` over those class pairs), each class pair on
    its own, and the pass by part: kernel 3's template part on the class
    pairs with Lb, Lk <= 4, the f-shell class pairs, and the digestion (the
    whole pass less both)."""
    from qchem_rs_tpu_torch.ops.eri_kernel import ket_contract
    from qchem_rs_tpu_torch.ops.fock_stream import StreamingFockBuilder

    builder = StreamingFockBuilder(system, 1e-12, device="cuda")
    eng = builder.engine
    metas = eng.layout.metas

    def highl(i1, i2):
        return max(metas[i1].la + metas[i1].lb, metas[i2].la + metas[i2].lb) > \
            eri_kernel.KERNEL_MAX_SIDE

    ks_hi = [k for k, b in enumerate(builder.batches) if highl(*b[:2])]
    ks_lo = [k for k, b in enumerate(builder.batches) if not highl(*b[:2])]
    old_batches = [b for b in eng.batches(values=False) if highl(*b[:2])]
    twin_batches = [b for b in eng.batches(twin=True) if highl(*b[:2])]
    worst, same = 0.0, True
    for b in twin_batches:
        out, again = eng.values_batch(*b), eng.values_batch(*b)
        ref = eng.values_batch(*b, fn=eri_kernel.tile_values_plain)
        err, rel = rel_err(out, ref)
        same = same and torch.equal(out, again)
        if not rel <= KERNEL3_RTOL:
            fail(f"kernel 3's high-L part disagrees with its twin on ferrocene class pair "
                 f"{class_name(metas[b[0]], metas[b[1]])}: {rel:.3e}")
        worst = max(worst, err)
    print(f"kernel 3's high-L part on ferrocene's {len(twin_batches)} twin-sized f-shell batches: "
          f"max abs err {worst:.3e}, relaunches bit-identical {same}", flush=True)
    if not same:
        fail("two launches of kernel 3's high-L part on a ferrocene batch differ")
    D = torch.tensor(density, device="cuda")[None]
    parts = (eri_kernel.VALUES_KERNEL, eri_kernel.VALUES_HIGHL_KERNEL, eri_kernel.KERNEL,
             eri_kernel.HIGHL_KERNEL)
    before = [k.launches for k in parts]
    J1, K1 = builder.jk_stack_cart(D)
    torch.cuda.synchronize()
    per_pass = [k.launches - b for k, b in zip(parts, before)]
    J2, K2 = builder.jk_stack_cart(D)
    same = torch.equal(J1, J2) and torch.equal(K1, K2)
    print(f"direct pass on ferrocene twice: J and K bit-identical {same}; launches a pass: kernel 3 "
          f"{per_pass[0]}, its high-L part {per_pass[1]}, kernel 1 {per_pass[2]} and {per_pass[3]}",
          flush=True)
    if not same:
        fail("two direct passes on the same ferrocene density differ")
    if per_pass != [len(ks_lo), len(ks_hi), 0, 0]:
        fail(f"a ferrocene direct pass launched {per_pass}, not [{len(ks_lo)}, {len(ks_hi)}, 0, 0]")

    def values(ks):
        for k in ks:
            builder.tile_values(k)

    def old():
        for i1, i2, ti, tj in old_batches:
            ket_contract(eng.bra_batch(i1, i2, ti, tj), eng._padded[i2][0], tj, metas[i2].tile)

    new_ms, old_ms, lo_ms, full = [], [], [], []
    for _ in range(2):  # in turns: new part, old route, old route, new part
        new_ms.append(cuda_ms(lambda: values(ks_hi), 5))
        old_ms.append(cuda_ms(old, 5))
        old_ms.append(cuda_ms(old, 5))
        new_ms.append(cuda_ms(lambda: values(ks_hi), 5))
        lo_ms.append(cuda_ms(lambda: values(ks_lo), 3))
        full.append(cuda_ms(lambda: builder.jk_stack_cart(D), 3))
    plain_ms = cuda_ms(
        lambda: [eng.values_batch(*b, fn=eri_kernel.tile_values_plain) for b in twin_batches], 1)
    dev_ms = device_ms(lambda: values(ks_hi), 5, ("eri_tile_values_highl",))
    nbytes, flops = eng.values_kernel_work(lambda Lb, Lk: max(Lb, Lk) > eri_kernel.KERNEL_MAX_SIDE)
    bytes_ms, flops_ms = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP64_FLOP_PER_S * 1e3
    res = {"launches_per_pass": len(ks_hi), "max_abs_err": worst, "ms": float(np.mean(new_ms)),
           "device_ms": dev_ms, "old_route_ms": float(np.mean(old_ms)), "plain_ms": plain_ms,
           "bound_ms": max(bytes_ms, flops_ms), "library_ms": None,
           "bound_by": "bytes" if bytes_ms >= flops_ms else "operations"}
    pass_ms, lo = float(np.mean(full)), float(np.mean(lo_ms))
    print(f"ferrocene f-shell class pairs of a direct pass ({len(ks_hi)} launches of kernel 3's "
          f"high-L part, {len(old_batches)} of kernel 1's in its own batches): new part "
          f"{res['ms']:.4f} ms (runs {new_ms}; its kernel on the device {dev_ms:.4f} ms), old route "
          f"kernel 1's high-L part + ket_contract over the same tiles {res['old_route_ms']:.4f} ms "
          f"(runs {old_ms}), twin {plain_ms:.3f} ms; must move {nbytes / 1e9:.4f} GB "
          f"({bytes_ms:.4f} ms) and do {flops / 1e9:.3f} GFLOP ({flops_ms:.4f} ms): bound "
          f"{res['bound_ms']:.4f} ms by {res['bound_by']}", flush=True)
    print(f"ferrocene direct pass by part: {pass_ms:.3f} ms (runs {full}); kernel 3's template "
          f"part on the class pairs with Lb, Lk <= 4 {lo:.3f} ms ({len(ks_lo)} launches, runs "
          f"{lo_ms}), the f-shell class pairs {res['ms']:.3f} ms (old route {res['old_route_ms']:.3f} "
          f"ms), digestion {pass_ms - lo - res['ms']:.3f} ms", flush=True)
    rows = []
    for i1, i2 in sorted({builder.batches[k][:2] for k in ks_hi}):
        ks = [k for k in ks_hi if builder.batches[k][:2] == (i1, i2)]
        ob = [b for b in old_batches if b[:2] == (i1, i2)]
        ms = cuda_ms(lambda: values(ks), 3)
        oms = cuda_ms(lambda: [ket_contract(eng.bra_batch(*b), eng._padded[i2][0], b[3],
                                            metas[i2].tile) for b in ob], 3)
        cb, cf = eng.values_kernel_work(pairs={(i1, i2)})
        rows.append((ms, class_name(metas[i1], metas[i2]), len(ks), oms,
                     max(cb / HBM_BYTES_PER_S, cf / FP64_FLOP_PER_S) * 1e3, cb, cf))
    for ms, name, n, oms, bound, cb, cf in sorted(rows, reverse=True):
        print(f"kernel 3 high-L class {name}: {ms:.4f} ms ({n} launches), old route {oms:.4f} ms, "
              f"own bound {bound:.4f} ms ({cb / 1e9:.4f} GB, {cf / 1e9:.4f} GFLOP), time/bound "
              f"{ms / bound:.1f}", flush=True)
    if not res["ms"] <= res["old_route_ms"]:
        fail("kernel 3's high-L part is slower than kernel 1's high-L part + ket_contract over the "
             "same tiles")
    return res


def zinc_atom(Q, kernels: dict, paths: dict) -> None:
    """RHF on the Zn atom in 6-31G* (39 AOs, an f shell) on the card and
    through the port on the CPU: the energies must agree within 1e-9. Both
    converge to diag_rms 1e-12: at 1e-10 the stop rule leaves the energy
    some 3e-9 from the fixed point, and the two devices' trajectories (their
    sums run in different orders) may stop on different passes."""
    basis = Q.BasisSet.load(os.path.join(ROOT, "data", "basis", "6-31G_st.json"))
    system = Q.MolecularSystem.from_arrays(np.array([30]), np.zeros((1, 3)), basis)
    cfg = Q.HartreeFockConfig(epsilon=1e-12, max_iterations=200)
    out, launches, peak, _ = drive(
        kernels, "Zn atom/6-31G* incore", lambda: Q.restricted_hartree_fock(system, cfg, device="cuda"),
        ("eri_tile", "eri_tile_highl", "fock_matvec"))
    paths["rhf zinc atom incore"] = dict(launches, iterations=out.iterations, peak_bytes=peak,
                                         total_s=out.timings["total_s"])
    t0 = time.perf_counter()
    cpu = Q.restricted_hartree_fock(system, cfg, device="cpu")
    dE = out.total_energy() - cpu.total_energy()
    print(f"Zn atom/6-31G*: card {out.total_energy():.10f}, CPU {cpu.total_energy():.10f} "
          f"({cpu.iterations} iterations, {time.perf_counter() - t0:.1f} s), dE {dE:.2e}", flush=True)
    if not (cpu.converged and abs(dE) <= 1e-9):
        fail(f"the Zn atom on the card lies {dE:.2e} Eh from the CPU run")


def water_field(Q, kernels: dict, paths: dict) -> None:
    """Water/cc-pVDZ in a field F = +-1e-3 z (a.u.), in core at diag_rms
    1e-10: the central difference -(E(+F) - E(-F)) / 2F against the z
    dipole of the field-free density (1e-5 a.u.), and the +F run in direct
    mode against the in-core one (1e-9 Eh)."""
    from qchem_rs_tpu_torch.models.properties import dipole_moment

    system = load_system(Q, "water")
    F = 1e-3
    runs = {}
    for label, mode, field, used in (
        ("no field", "incore", 0.0, ("eri_tile", "fock_matvec")),
        ("+F", "incore", F, ("eri_tile", "fock_matvec")),
        ("-F", "incore", -F, ("eri_tile", "fock_matvec")),
        ("+F direct", "direct", F, ("eri_tile_values",)),
    ):
        cfg = Q.HartreeFockConfig(epsilon=1e-10, max_iterations=100, fock_mode=mode,
                                  electric_field=(0.0, 0.0, field))
        out, launches, peak, _ = drive(kernels, f"water/cc-pVDZ field {label}",
                                       lambda: Q.restricted_hartree_fock(system, cfg, device="cuda"),
                                       used)
        paths[f"rhf water field {label}"] = dict(launches, iterations=out.iterations,
                                                 peak_bytes=peak, total_s=out.timings["total_s"])
        runs[label] = out
    mu = dipole_moment(system, runs["no field"].density, "cuda")
    fd = -(runs["+F"].total_energy() - runs["-F"].total_energy()) / (2 * F)
    dE = runs["+F direct"].total_energy() - runs["+F"].total_energy()
    print(f"water/cc-pVDZ field: -dE/dF_z {fd:.8f}, dipole_moment z {mu[2]:.8f} a.u. (difference "
          f"{fd - mu[2]:.2e}); +F direct - in-core {dE:.2e} Eh", flush=True)
    if abs(fd - mu[2]) > 1e-5 or abs(dE) > 1e-9:
        fail("the water/cc-pVDZ field runs miss the dipole or disagree across modes")


def benzene_checkpoint(Q, system) -> None:
    """Benzene/cc-pVDZ in core to diag_rms 1e-10 (at 1e-8 the stop leaves
    the energy some 1e-8 Eh from the fixed point, so a resumed run could not
    be held to 1e-9), a checkpoint of it written and read back, and the run
    resumed from it: it must converge in at most 2 iterations to within
    1e-9 Eh."""
    import tempfile

    from qchem_rs_tpu_torch.utils.checkpoint import ScfCheckpoint, from_rhf_output

    cfg = Q.HartreeFockConfig(epsilon=1e-10, max_iterations=150)
    out = Q.restricted_hartree_fock(system, cfg, device="cuda")
    print(f"benzene/cc-pVDZ at diag_rms 1e-10: E {out.total_energy():.10f}, {out.iterations} "
          f"iterations", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "benzene.npz")
        from_rhf_output(out, system).save(path)
        ck = ScfCheckpoint.load(path)
    resumed = Q.restricted_hartree_fock(system, cfg, density_guess=ck.density, device="cuda")
    dE = resumed.total_energy() - out.total_energy()
    print(f"benzene/cc-pVDZ resumed from its checkpoint: {resumed.iterations} iterations, dE "
          f"{dE:.2e}, total_s {resumed.timings['total_s']:.4f}", flush=True)
    if not (resumed.converged and resumed.iterations <= 2 and abs(dE) <= 1e-9):
        fail("the benzene run resumed from its checkpoint did not converge at once to its energy")


def drive_mp2(kernels: dict, label: str, fn, scf_s: float):
    """One MP2 call with every launch count set to 0 just before and read
    just after, the peak device memory reset before; fails unless kernel 1
    was launched. Returns (output, launches, peak bytes)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset(kernels)
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launches_of(kernels)
    peak = torch.cuda.max_memory_allocated()
    tm = res.timings
    print(f"{label}: correlation_energy {res.correlation_energy:.12f}, total {res.total_energy():.10f}; "
          f"SCF total_s {scf_s:.4f}; MP2 wall {wall:.4f} s (eri_s {tm['eri_s']:.4f}, transform_s "
          f"{tm['transform_s']:.4f}, total_s {tm['total_s']:.4f}); peak device memory "
          f"{peak / 1e9:.3f} GB; launches {launches}", flush=True)
    if launches["eri_tile"] == 0:
        fail(f"{label} did not launch kernel 1")
    return res, launches, peak


def mp2_runs(Q, kernels: dict, paths: dict) -> None:
    """MP2: water/cc-pVDZ against its anchor; naphthalene/cc-pVDZ (SCF to
    diag_rms 1e-10 from SAD in pair mode, and the same with a level shift
    of 0.3 Eh, which must land within 1e-8 of it) in core and in pair space
    with frozen 0 and "auto", the two agreeing within 1e-9; UMP2 on triplet
    O2/6-31G in core against pair space. Returns the naphthalene system,
    config and SCF output."""
    system = load_system(Q, "water")
    cfg = Q.HartreeFockConfig(epsilon=1e-10, max_iterations=200)
    res, launches, peak = drive_mp2(kernels, "MP2 water/cc-pVDZ incore",
                                    lambda: Q.mp2(system, cfg, device="cuda"), float("nan"))
    paths["mp2 water incore"] = dict(launches, peak_bytes=peak)
    dc, dE = res.correlation_energy - WATER_MP2_CORR, res.total_energy() - WATER_MP2_E
    print(f"MP2 water/cc-pVDZ: correlation {dc:.2e}, total {dE:.2e} from the anchor", flush=True)
    if abs(dc) > 1e-9 or abs(dE) > 1e-9:
        fail("MP2 water/cc-pVDZ misses its anchor")

    system = load_system(Q, "naphthalene")
    cfg = Q.HartreeFockConfig(epsilon=1e-10, max_iterations=200, fock_mode="pair",
                              initial_guess="sad")
    out, _, _, _ = drive(kernels, "naphthalene/cc-pVDZ pair sad diag_rms 1e-10",
                         lambda: Q.restricted_hartree_fock(system, cfg, device="cuda"),
                         ("eri_tile", "fock_matvec"))
    scf_s = out.timings["total_s"]
    # a level-shifted run lands on the same fixed point (at diag_rms 1e-8
    # the stop leaves each run ~1e-7 Eh from it, so both go to 1e-10)
    shifted_cfg = Q.HartreeFockConfig(epsilon=1e-10, max_iterations=200, fock_mode="pair",
                                      initial_guess="sad", level_shift=0.3)
    shifted, launches, peak, _ = drive(
        kernels, "naphthalene/cc-pVDZ pair sad diag_rms 1e-10 level shift 0.3",
        lambda: Q.restricted_hartree_fock(system, shifted_cfg, device="cuda"),
        ("eri_tile", "fock_matvec"))
    paths["rhf naphthalene pair sad level shift"] = dict(
        launches, iterations=shifted.iterations, peak_bytes=peak, total_s=shifted.timings["total_s"])
    dE = shifted.total_energy() - out.total_energy()
    print(f"naphthalene/cc-pVDZ pair sad level shift 0.3: dE {dE:.2e} from the unshifted run; "
          f"iterations {shifted.iterations} shifted, {out.iterations} unshifted", flush=True)
    if abs(dE) > 1e-8:
        fail(f"the level-shifted naphthalene run lies {dE:.2e} Eh from the unshifted one")
    for frozen in (0, "auto"):
        energies = []
        for name, fn in (("incore", Q.mp2), ("pair", Q.mp2_pair_space)):
            res, launches, peak = drive_mp2(
                kernels, f"MP2 naphthalene/cc-pVDZ {name} frozen {frozen}",
                lambda: fn(system, cfg, frozen=frozen, output=out, device="cuda"), scf_s)
            key = f"mp2 naphthalene {name}" + ("" if frozen == 0 else " frozen auto")
            paths[key] = dict(launches, peak_bytes=peak, total_s=res.timings["total_s"])
            energies.append(res.correlation_energy)
        diff = energies[0] - energies[1]
        print(f"MP2 naphthalene/cc-pVDZ frozen {frozen}: incore - pair {diff:.2e}", flush=True)
        if abs(diff) > 1e-9:
            fail(f"naphthalene MP2 in core and in pair space disagree (frozen {frozen}): {diff:.2e}")

    naphthalene = (system, cfg, out)
    system = load_system(Q, "oxygen", "6-31G")
    cfg = Q.HartreeFockConfig(epsilon=1e-10, max_iterations=300, spin_multiplicity=3)
    out, _, _, _ = drive(kernels, "UHF O2/6-31G triplet for UMP2",
                         lambda: Q.unrestricted_hartree_fock(system, cfg, device="cuda"),
                         ("eri_tile", "fock_matvec"))
    energies = []
    for name, fn in (("incore", Q.ump2), ("pair", Q.ump2_pair_space)):
        res, launches, peak = drive_mp2(kernels, f"UMP2 O2/6-31G triplet {name}",
                                        lambda: fn(system, cfg, output=out, device="cuda"),
                                        out.timings["total_s"])
        paths[f"ump2 oxygen {name}"] = dict(launches, peak_bytes=peak)
        energies.append(res.correlation_energy)
    diff = energies[0] - energies[1]
    print(f"UMP2 O2/6-31G triplet: incore - pair {diff:.2e}", flush=True)
    if abs(diff) > 1e-9 or not energies[0] < 0.0:
        fail(f"UMP2 O2/6-31G in core and in pair space disagree: {energies}")
    return naphthalene


def cli_mp2() -> None:
    """The CLI's mp2 subcommand on water/cc-pVDZ as a user runs it: exit 0,
    and the anchor's energies to their printed digits."""
    cmd = [sys.executable, "-m", "qchem_rs_tpu_torch.cli", "mp2", "-b", "data/basis/cc-pVDZ.json",
           "-m", "data/mol/water.json", "--epsilon", "1e-10"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
    print(f"CLI {' '.join(cmd[1:])}: exit {proc.returncode} in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for line in proc.stdout.splitlines():
        print(f"  {line}", flush=True)
    want = [f"mp2 correlation energy: {WATER_MP2_CORR:3.6f}", f"mp2 total energy: {WATER_MP2_E:3.6f}"]
    if proc.returncode != 0 or not all(w in proc.stdout.splitlines() for w in want):
        fail(f"the CLI's mp2 did not print {want}: {proc.stderr[-2000:]}")


# --------------------------------------------------------------------------
# the correlated tier past MP2
# --------------------------------------------------------------------------


def gate(label: str, value: float, limit: float) -> None:
    """Print |value| beside its limit; fail when it passes it."""
    print(f"{label}: {value:.3e} (limit {limit:.0e})", flush=True)
    if not abs(value) <= limit:
        fail(f"{label} is {value:.3e}, past {limit:.0e}")


def drive_cc(kernels: dict, label: str, fn, used=("eri_tile",)):
    """One CC call with every launch count set to 0 just before and read
    just after, the peak device memory reset before; fails unless each
    kernel in ``used`` was launched and the amplitudes converged. Prints the
    run by part. Returns (output, launches, peak bytes, wall s)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset(kernels)
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launches_of(kernels)
    peak = torch.cuda.max_memory_allocated()
    tm = res.timings
    per_it = tm["cc_s"] / max(res.iterations, 1)
    print(f"{label}: E_corr {res.correlation_energy:.12f}, (T) {res.triples_correction}, total "
          f"{res.total_energy():.10f}, {res.iterations} CC iterations, converged {res.converged}; "
          f"wall {wall:.4f} s (eri_s {tm['eri_s']:.4f}, blocks_s {tm['blocks_s']:.4f}, cc_s "
          f"{tm['cc_s']:.4f} = {res.iterations} x {per_it:.4f}, triples_s {tm['triples_s']:.4f}); "
          f"peak device memory {peak / 1e9:.3f} GB; launches {launches}", flush=True)
    if not res.converged:
        fail(f"{label} did not converge")
    missing = [name for name in used if launches[name] == 0]
    if missing:
        fail(f"{label} bypassed {missing}: {launches}")
    return res, launches, peak, wall


def benzene_ccsd_t(Q, kernels: dict, paths: dict):
    """The headline: benzene/cc-pVDZ RHF (in core, SAD, diag_rms 1e-10)
    then spatial CCSD(T), frozen 0 and "auto", in core and in pair space;
    the first (RHF and CCSD(T) frozen 0 in core) is the main path, driven
    with the counts set to 0 before the SCF. Gates: in core - pair within
    1e-9 Eh for CCSD and (T); iteration 0 equals the port's MP2 on the same
    output within 1e-10; a second in-core run gives equal bits. Returns the
    system, config and SCF output."""
    from qchem_rs_tpu_torch.models.cc import ccsd

    system = load_system(Q, "benzene")
    cfg = Q.HartreeFockConfig(epsilon=1e-10, max_iterations=150, initial_guess="sad")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset(kernels)
    t0 = time.perf_counter()
    out = Q.restricted_hartree_fock(system, cfg, device="cuda")
    torch.cuda.synchronize()
    scf_wall = time.perf_counter() - t0
    head = ccsd(system, cfg, triples=True, output=out, device="cuda")
    torch.cuda.synchronize()
    launches = launches_of(kernels)
    peak = torch.cuda.max_memory_allocated()
    tm = head.timings
    print(f"benzene/cc-pVDZ RHF + CCSD(T) (main path): SCF {out.iterations} iterations, "
          f"E_SCF {out.total_energy():.10f}, SCF wall {scf_wall:.4f} s (guess_s "
          f"{out.timings.get('guess_s', 0.0):.4f}, eri_s {out.timings['eri_s']:.4f}, scf_s "
          f"{out.timings['scf_s']:.4f}); CCSD(T) total_s {tm['total_s']:.4f}; peak device memory "
          f"{peak / 1e9:.3f} GB; launches {launches}", flush=True)
    if not (out.converged and head.converged):
        fail("the benzene/cc-pVDZ RHF + CCSD(T) main path did not converge")
    if not all(v > 0 for k, v in launches.items() if k in ("eri_tile", "fock_matvec")):
        fail(f"the benzene RHF + CCSD(T) main path bypassed a kernel: {launches}")
    paths["rhf + ccsd(t) benzene incore sad"] = dict(launches, peak_bytes=peak,
                                                      scf_s=scf_wall, **tm)
    runs = {}
    for frozen in (0, "auto"):
        mp2 = Q.mp2(system, cfg, frozen=frozen, output=out, device="cuda").correlation_energy
        for mode in ("incore", "pair"):
            run_cfg = Q.HartreeFockConfig(epsilon=1e-10, max_iterations=150, initial_guess="sad",
                                          fock_mode=mode)
            label = f"CCSD(T) benzene/cc-pVDZ {mode} frozen {frozen}"
            res, launches, peak, wall = drive_cc(
                kernels, label, lambda: ccsd(system, run_cfg, frozen=frozen, triples=True,
                                             output=out, device="cuda"))
            paths[f"ccsd(t) benzene {mode} frozen {frozen}"] = dict(
                launches, peak_bytes=peak, wall_s=wall, iterations=res.iterations, **res.timings)
            runs[mode, frozen] = res
        gate(f"benzene frozen {frozen}: CCSD iteration 0 - MP2",
             runs["incore", frozen].mp2_correlation_energy - mp2, 1e-10)
        for part in ("correlation_energy", "triples_correction"):
            gate(f"benzene frozen {frozen}: {part} in core - pair",
                 getattr(runs["incore", frozen], part) - getattr(runs["pair", frozen], part), 1e-9)
    again = ccsd(system, cfg, triples=True, output=out, device="cuda")
    same = (again.correlation_energy == runs["incore", 0].correlation_energy
            and again.triples_correction == runs["incore", 0].triples_correction
            and again.iterations == runs["incore", 0].iterations
            and head.correlation_energy == again.correlation_energy)
    print(f"CCSD(T) benzene/cc-pVDZ in core three times: energy bits equal {same}", flush=True)
    if not same:
        fail("two benzene CCSD(T) runs on the same inputs differ")
    return system, cfg, out


def water_ccsd_t(Q, kernels: dict, paths: dict) -> None:
    """Water/cc-pVDZ CCSD(T): spatial against spinorbital within 1e-10,
    the batched (T) against the full-tensor form within 1e-12, and within
    1e-9 of the JAX package's value on the CPU."""
    from qchem_rs_tpu_torch.models import cc

    system = load_system(Q, "water")
    cfg = Q.HartreeFockConfig(epsilon=1e-10, max_iterations=200)
    out = Q.restricted_hartree_fock(system, cfg, device="cuda")
    res = {}
    for form in ("spatial", "spinorbital"):
        res[form], launches, peak, _ = drive_cc(
            kernels, f"CCSD(T) water/cc-pVDZ {form}",
            lambda: cc.ccsd(system, cfg, triples=True, cc_epsilon=1e-10, formulation=form,
                            output=out, device="cuda"))
        paths[f"ccsd(t) water {form}"] = dict(launches, peak_bytes=peak, **res[form].timings)
    sp, so = res["spatial"], res["spinorbital"]
    gate("water CCSD spatial - spinorbital", sp.correlation_energy - so.correlation_energy, 1e-10)
    gate("water (T) spatial - spinorbital", sp.triples_correction - so.triples_correction, 1e-10)
    gate("water CCSD(T) total - JAX anchor", sp.total_energy() - WATER_CCSD_T_E, 1e-9)
    gate("water CCSD correlation - JAX anchor", sp.correlation_energy - WATER_CCSD_CORR, 1e-9)
    gate("water (T) - JAX anchor", sp.triples_correction - WATER_CCSD_T, 1e-9)
    nocc = system.n_electrons() // 2
    C = torch.as_tensor(out.coefficients, device="cuda")
    eps = torch.as_tensor(out.orbital_energies, device="cuda")
    g = cc._mo_phys_blocks(cc._incore_e4(system, cfg, torch.device("cuda")), C[:, :nocc],
                           C[:, nocc:])
    _, (t1, T, *_rest) = cc.spatial_amplitudes(g, eps[:nocc], eps[nocc:], 100, 1e-10)
    full = float(cc._triples_energy_rhf(t1, T, eps[:nocc], eps[nocc:], g))
    batched = float(cc._triples_energy_rhf_batched(t1, T, eps[:nocc], eps[nocc:], g))
    gate("water (T) batched - full", batched - full, 1e-12)


def uccsd_t(Q, kernels: dict, paths: dict) -> None:
    """UCCSD(T) on OH/6-31G (doublet) and O2/6-31G (triplet) on UHF at
    diag_rms 1e-12, the card against the port on the CPU (same UHF)."""
    from qchem_rs_tpu_torch.models.cc import ccsd

    for mol, mult in (("hydroxyl", 2), ("oxygen", 3)):
        system = load_system(Q, mol, "6-31G")
        cfg = Q.HartreeFockConfig(epsilon=1e-12, max_iterations=600, spin_multiplicity=mult)
        out = Q.unrestricted_hartree_fock(system, cfg, device="cuda")
        if not out.converged:
            fail(f"UHF {mol}/6-31G at 1e-12 did not converge")
        res, launches, peak, _ = drive_cc(
            kernels, f"UCCSD(T) {mol}/6-31G multiplicity {mult}",
            lambda: ccsd(system, cfg, triples=True, cc_epsilon=1e-10, output=out, device="cuda"))
        paths[f"uccsd(t) {mol}"] = dict(launches, peak_bytes=peak, **res.timings)
        t0 = time.perf_counter()
        cpu = ccsd(system, cfg, triples=True, cc_epsilon=1e-10, output=out, device="cpu")
        print(f"UCCSD(T) {mol}/6-31G on the CPU: {time.perf_counter() - t0:.2f} s", flush=True)
        if not (res.correlation_energy < 0.0 and res.mp2_correlation_energy < 0.0
                and res.triples_correction < 0.0):
            fail(f"UCCSD(T) {mol}/6-31G: a correlation energy is not negative: {res}")
        gate(f"UCCSD(T) {mol}/6-31G card - CPU", res.total_energy() - cpu.total_energy(), 1e-10)


def timed(label: str, fn):
    """``fn()`` with its wall time and peak device memory printed."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    print(f"{label}: wall {time.perf_counter() - t0:.4f} s, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB", flush=True)
    return out


def cis_runs(Q, kernels: dict, paths: dict, naphthalene, benzene) -> None:
    """CIS on naphthalene/cc-pVDZ (pair mode, Davidson: no*nv = 5304) against
    in-core Davidson within 1e-7; dense TDHF singlets and triplets on
    benzene/cc-pVDZ; UCIS on O2/6-31G against the CPU."""
    from qchem_rs_tpu_torch.models.cis import cis, ucis

    system, cfg, out = naphthalene
    w = {}
    for mode in ("pair", "incore"):
        run_cfg = Q.HartreeFockConfig(epsilon=1e-10, max_iterations=200, fock_mode=mode,
                                      initial_guess="sad")
        reset(kernels)
        res = timed(f"CIS naphthalene/cc-pVDZ {mode} Davidson, 5 singlets",
                    lambda: cis(system, run_cfg, nstates=5, output=out, device="cuda"))
        launches = launches_of(kernels)
        print(f"  excitation energies {res.excitation_energies}, f {res.oscillator_strengths}, "
              f"launches {launches}", flush=True)
        if launches["eri_tile"] == 0:
            fail(f"CIS naphthalene {mode} did not launch kernel 1")
        paths[f"cis naphthalene {mode} davidson"] = launches
        w[mode] = res.excitation_energies
    gate("CIS naphthalene pair - in core (Davidson)", float(np.max(np.abs(w["pair"] - w["incore"]))),
         1e-7)
    system, cfg, out = benzene
    for triplet in (False, True):
        res = timed(f"TDHF benzene/cc-pVDZ dense {'triplets' if triplet else 'singlets'}",
                    lambda: cis(system, cfg, nstates=5, tdhf=True, triplet=triplet, output=out,
                                device="cuda"))
        w = res.excitation_energies
        print(f"  excitation energies {w}, f {res.oscillator_strengths}", flush=True)
        # RHF benzene is singlet-stable (A - B positive definite, else cis
        # raises) but triplet-unstable: the lowest triplet omega^2 is
        # negative and its omega prints as 0, as in the JAX package
        if not (np.all(np.isfinite(w)) and np.all(np.diff(w) >= 0) and w[0] >= 0.0
                and (triplet or w[0] > 0.0)):
            fail(f"TDHF benzene roots out of order: {w}")
    system = load_system(Q, "oxygen", "6-31G")
    cfg = Q.HartreeFockConfig(epsilon=1e-12, max_iterations=600, spin_multiplicity=3)
    out = Q.unrestricted_hartree_fock(system, cfg, device="cuda")
    res = timed("UCIS O2/6-31G triplet dense", lambda: ucis(system, cfg, output=out, device="cuda"))
    cpu = ucis(system, cfg, output=out, device="cpu")
    print(f"  excitation energies {res.excitation_energies}", flush=True)
    gate("UCIS O2/6-31G card - CPU",
         float(np.max(np.abs(res.excitation_energies - cpu.excitation_energies))), 1e-8)


def fci_water(Q) -> None:
    """FCI on water/STO-3G (441 determinants): the card against the CPU."""
    from qchem_rs_tpu_torch.models.fci import fci

    system = load_system(Q, "water", "STO-3G")
    cfg = Q.HartreeFockConfig(epsilon=1e-10, max_iterations=200)
    card = timed("FCI water/STO-3G", lambda: fci(system, cfg, nroots=3, device="cuda"))
    cpu = fci(system, cfg, nroots=3, device="cpu")
    print(f"  {card.dimension} determinants, roots {card.total_energies}", flush=True)
    gate("FCI water/STO-3G card - CPU",
         float(np.max(np.abs(card.total_energies - cpu.total_energies))), 1e-10)


def eom_runs(Q, kernels: dict, paths: dict) -> None:
    """EOM-CCSD: matrix-free spatial on benzene/cc-pVDZ (3 singlets);
    spinorbital on water/cc-pVDZ, right and left (within 1e-6); on
    water/STO-3G the determinant tier against the matrix-free tier (within
    1e-6), IP and EA against the CPU, and the matrix-free transition moments
    against the determinant-space properties."""
    from qchem_rs_tpu_torch.models import eom

    system = load_system(Q, "benzene")
    cfg = Q.HartreeFockConfig(epsilon=1e-10, max_iterations=150, initial_guess="sad")
    reset(kernels)
    res = timed("EOM-EE-CCSD benzene/cc-pVDZ matrix-free spatial, 3 singlets",
                lambda: eom.eom_ccsd_davidson(system, cfg, nstates=3, formulation="spatial",
                                              device="cuda"))
    launches = launches_of(kernels)
    paths["eom benzene spatial"] = launches
    print(f"  excitation energies {res.excitation_energies} Eh, {res.cc_iterations} CC "
          f"iterations, amplitude space {res.dimension}, launches {launches}", flush=True)
    if not (np.all(np.diff(res.excitation_energies) >= 0) and 0 < res.excitation_energies[0] < 1):
        fail(f"EOM benzene roots out of range: {res.excitation_energies}")

    system = load_system(Q, "water")
    cfg = Q.HartreeFockConfig(epsilon=1e-10, max_iterations=200)
    res = timed("EOM-EE-CCSD water/cc-pVDZ matrix-free spinorbital, right and left",
                lambda: eom.eom_ccsd_davidson(system, cfg, nstates=3, left=True, device="cuda"))
    print(f"  right {res.excitation_energies}, left {res.left_excitation_energies}", flush=True)
    gate("EOM water/cc-pVDZ left - right",
         float(np.max(np.abs(res.left_excitation_energies - res.excitation_energies))), 1e-6)

    system = load_system(Q, "water", "STO-3G")
    det = timed("EOM-CCSD water/STO-3G determinant tier",
                lambda: eom.eom_ccsd(system, cfg, nstates=4, device="cuda"))
    mf = eom.eom_ccsd_davidson(system, cfg, nstates=4, tol=1e-7, device="cuda")
    gate("EOM water/STO-3G determinant - matrix-free",
         float(np.max(np.abs(det.excitation_energies - mf.excitation_energies))), 1e-6)
    for kind in ("ip", "ea"):
        fn = getattr(eom, f"{kind}_eom_ccsd")
        card, cpu = fn(system, cfg, device="cuda"), fn(system, cfg, device="cpu")
        print(f"  {kind}: {card.energies}", flush=True)
        gate(f"{kind.upper()}-EOM water/STO-3G card - CPU",
             float(np.max(np.abs(card.energies - cpu.energies))), 1e-8)
    props = eom.eom_ccsd_properties(system, cfg, nstates=4, cc_epsilon=1e-11, device="cuda")
    tm = timed("EOM-CCSD water/STO-3G matrix-free transition moments",
               lambda: eom.eom_ccsd_transition_moments(system, cfg, nstates=4, tol=1e-8,
                                                       cc_epsilon=1e-11, device="cuda"))
    print(f"  f {tm.oscillator_strengths} (determinant tier {props.oscillator_strengths})",
          flush=True)
    gate("EOM transition moments: oscillator strengths - determinant tier",
         float(np.max(np.abs(tm.oscillator_strengths - props.oscillator_strengths))), 1e-5)
    gate("EOM transition moments: ground-state dipole - determinant tier",
         float(np.max(np.abs(tm.ground_state_dipole - props.ground_state_dipole))), 1e-6)


def cc_dipoles(Q) -> None:
    """ccsd_dipole and ccsd_relaxed_dipole on water/cc-pVDZ; the relaxed z
    component within 1e-5 a.u. of the central difference of CCSD total
    energies in a field of +-1e-4 z (the SCF re-converged in each)."""
    import dataclasses

    from qchem_rs_tpu_torch.models.cc import ccsd
    from qchem_rs_tpu_torch.models.cc_lambda import ccsd_dipole
    from qchem_rs_tpu_torch.models.cc_relaxed import ccsd_relaxed_dipole

    system = load_system(Q, "water")
    cfg = Q.HartreeFockConfig(epsilon=1e-11, max_iterations=300)
    unrel = timed("CCSD dipole (unrelaxed) water/cc-pVDZ",
                  lambda: ccsd_dipole(system, cfg, device="cuda"))
    rel = timed("CCSD dipole (relaxed) water/cc-pVDZ",
                lambda: ccsd_relaxed_dipole(system, cfg, device="cuda"))
    h = 1e-4
    e = [ccsd(system, dataclasses.replace(cfg, electric_field=(0.0, 0.0, s * h)), cc_epsilon=1e-11,
              device="cuda").total_energy() for s in (1, -1)]
    mu_fd = -(e[0] - e[1]) / (2 * h)
    print(f"  unrelaxed {unrel.ccsd_dipole}, relaxed {rel.ccsd_dipole}, scf {rel.scf_dipole}, "
          f"finite field z {mu_fd:.8f}, z residual {rel.z_residual:.2e}", flush=True)
    gate("unrelaxed dipole: the two entry points' values",
         float(np.max(np.abs(unrel.ccsd_dipole - rel.ccsd_dipole_unrelaxed))), 1e-10)
    gate("relaxed dipole z - finite field", rel.ccsd_dipole[2] - mu_fd, 1e-5)


def cli_ccsd() -> None:
    """The CLI's ccsd --triples on water/cc-pVDZ as a subprocess: exit 0 and
    the anchor's CCSD(T) total energy to its printed digits."""
    cmd = [sys.executable, "-m", "qchem_rs_tpu_torch.cli", "ccsd", "-b", "data/basis/cc-pVDZ.json",
           "-m", "data/mol/water.json", "--epsilon", "1e-10", "--triples"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
    print(f"CLI {' '.join(cmd[1:])}: exit {proc.returncode} in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for line in proc.stdout.splitlines():
        print(f"  {line}", flush=True)
    want = [f"ccsd total energy: {WATER_CCSD_T_E:3.6f}", f"(t) correction: {WATER_CCSD_T:3.6f}"]
    if proc.returncode != 0 or not all(w in proc.stdout.splitlines() for w in want):
        fail(f"the CLI's ccsd did not print {want}: {proc.stderr[-2000:]}")


# --------------------------------------------------------------------------
# the gradient and geometry tier
# --------------------------------------------------------------------------


def print_gradient(label: str, g) -> None:
    for i, row in enumerate(g):
        print(f"  {label} atom {i}: {row[0]: .12f} {row[1]: .12f} {row[2]: .12f}", flush=True)


def gradient_parts(label: str, tm: dict, wall: float) -> None:
    print(f"{label}: wall {wall:.4f} s = scf_s {tm['scf_s']:.4f} + g0_s {tm['g0_s']:.4f} + "
          f"one_electron_s {tm['one_electron_s']:.4f} + two_electron_s {tm['two_electron_s']:.4f} "
          f"({tm['segments']} segments, peak device memory "
          f"{tm['two_electron_peak_bytes'] / 1e9:.3f} GB)", flush=True)


def hexagon(positions: np.ndarray) -> np.ndarray:
    """data/mol/benzene.json's atoms placed exactly on their hexagons: each
    ring (C, then H) at its mean radius, at multiples of 60 degrees. The
    file's coordinates carry 8 decimals, so its D6h holds to ~1e-8 Bohr,
    which moves the gradient's components by a few 1e-9 Eh/Bohr."""
    out = np.zeros_like(positions)
    for ring in (slice(0, 6), slice(6, 12)):
        p = positions[ring]
        r = float(np.hypot(p[:, 0], p[:, 1]).mean())
        k = np.round(np.degrees(np.arctan2(p[:, 1], p[:, 0])) / 60.0)
        angle = np.radians(60.0 * k)
        out[ring, 0], out[ring, 1] = r * np.cos(angle), r * np.sin(angle)
    return out


def benzene_gradient(Q, kernels: dict, paths: dict):
    """The headline of this tier: benzene/cc-pVDZ RHF (in core, SAD,
    diag_rms 1e-10) and its analytic gradient, the counts set to 0 before
    the SCF, at the file's geometry placed exactly on its hexagons
    (``hexagon``). Gates: the sum over atoms within 1e-9 Eh/Bohr, every z
    component within 1e-10 (the molecule is planar), the six C and the six H
    radial components equal within 1e-9 (D6h), the x component of atom 0
    within 1e-6 of a central difference of the card's total energy at
    h = 1e-3 Bohr, a second gradient equal in bits, and the pair-mode
    gradient (its own SCF) within 1e-9 of the in-core one. Returns the
    system, config and SCF output."""
    system = load_system(Q, "benzene")
    system = system.with_positions(hexagon(system.positions))
    cfg = Q.HartreeFockConfig(epsilon=1e-10, max_iterations=150, initial_guess="sad")
    torch.cuda.synchronize()
    reset(kernels)
    t0 = time.perf_counter()
    out = Q.restricted_hartree_fock(system, cfg, device="cuda")
    tm = {}
    g = Q.rhf_gradient(system, cfg, output=out, device="cuda", timings=tm)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launches_of(kernels)
    tm["scf_s"] = out.timings["total_s"]
    gradient_parts(f"benzene/cc-pVDZ RHF + gradient (main path), E {out.total_energy():.10f}, "
                   f"{out.iterations} SCF iterations", tm, wall)
    print(f"  launches {launches}", flush=True)
    print_gradient("benzene", g)
    if not out.converged:
        fail("the benzene/cc-pVDZ SCF did not converge")
    if not (launches["eri_tile"] > 0 and launches["fock_matvec"] > 0):
        fail(f"the benzene gradient path bypassed a kernel: {launches}")
    paths["rhf + gradient benzene incore sad"] = dict(
        launches, wall_s=wall, peak_bytes=tm["two_electron_peak_bytes"],
        **{k: v for k, v in tm.items() if k != "two_electron_peak_bytes"})
    gate("benzene gradient: largest |sum over atoms|", float(np.abs(g.sum(axis=0)).max()), 1e-9)
    gate("benzene gradient: largest |z component|", float(np.abs(g[:, 2]).max()), 1e-10)
    pos = system.positions - system.positions.mean(axis=0)
    radial = (g * pos).sum(axis=1) / np.linalg.norm(pos, axis=1)
    for name, sl in (("C", slice(0, 6)), ("H", slice(6, 12))):
        print(f"  {name} radial components {radial[sl]}", flush=True)
        gate(f"benzene gradient: spread of the {name} radial components",
             float(np.ptp(radial[sl])), 1e-9)
    h = 1e-3
    energies = []
    for sign in (1.0, -1.0):
        x = system.positions.copy()
        x[0, 0] += sign * h
        run = Q.restricted_hartree_fock(system.with_positions(x), cfg, density_guess=out.density,
                                        device="cuda")
        if not run.converged:
            fail("a displaced benzene SCF did not converge")
        energies.append(run.total_energy())
    fd = (energies[0] - energies[1]) / (2.0 * h)
    print(f"  atom 0 x: analytic {g[0, 0]:.12f}, central difference {fd:.12f}", flush=True)
    gate("benzene gradient: atom 0 x - central difference (h = 1e-3)", g[0, 0] - fd, 1e-6)
    tm2 = {}
    t0 = time.perf_counter()
    again = Q.rhf_gradient(system, cfg, output=out, device="cuda", timings=tm2)
    tm2["scf_s"] = 0.0
    gradient_parts("benzene/cc-pVDZ gradient again (same SCF output)", tm2,
                   time.perf_counter() - t0)
    same = bool(np.array_equal(g, again))
    print(f"benzene gradient twice: bits equal {same}", flush=True)
    if not same:
        fail("two benzene gradients on the same inputs differ")
    pair_cfg = Q.HartreeFockConfig(epsilon=1e-10, max_iterations=150, initial_guess="sad",
                                   fock_mode="pair")
    reset(kernels)
    t0 = time.perf_counter()
    pair_out = Q.restricted_hartree_fock(system, pair_cfg, device="cuda")
    tm3 = {}
    gp = Q.rhf_gradient(system, pair_cfg, output=pair_out, device="cuda", timings=tm3)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launches_of(kernels)
    tm3["scf_s"] = pair_out.timings["total_s"]
    gradient_parts(f"benzene/cc-pVDZ RHF + gradient pair, E {pair_out.total_energy():.10f}", tm3,
                   wall)
    print(f"  launches {launches}", flush=True)
    if not (launches["eri_tile"] > 0 and launches["fock_matvec"] > 0):
        fail(f"the benzene pair gradient path bypassed a kernel: {launches}")
    paths["rhf + gradient benzene pair sad"] = dict(launches, wall_s=wall,
                                                    peak_bytes=tm3["two_electron_peak_bytes"])
    gate("benzene gradient: pair - in core", float(np.abs(gp - g).max()), 1e-9)
    return system, cfg, out


def uhf_gradient_oh(Q, kernels: dict, paths: dict) -> None:
    """UHF OH/6-31G (doublet, in core, diag_rms 1e-12): the card's gradient
    against the port's on the CPU within 1e-9, and its sum over atoms."""
    system = load_system(Q, "hydroxyl", "6-31G")
    cfg = Q.HartreeFockConfig(epsilon=1e-12, max_iterations=500, spin_multiplicity=2)
    reset(kernels)
    g = timed("UHF OH/6-31G SCF + gradient", lambda: Q.uhf_gradient(system, cfg, device="cuda"))
    launches = launches_of(kernels)
    print(f"  launches {launches}", flush=True)
    print_gradient("OH", g)
    if not (launches["eri_tile"] > 0 and launches["fock_matvec"] > 0):
        fail(f"the UHF gradient path bypassed a kernel: {launches}")
    paths["uhf + gradient hydroxyl incore"] = launches
    cpu = Q.uhf_gradient(system, cfg, device="cpu")
    gate("UHF OH/6-31G gradient: card - CPU", float(np.abs(g - cpu).max()), 1e-9)
    gate("UHF OH/6-31G gradient: largest |sum over atoms|", float(np.abs(g.sum(axis=0)).max()),
         1e-9)


def water_frequencies(Q, kernels: dict, paths: dict) -> list:
    """Water/cc-pVDZ: ``optimize_geometry`` from data/mol/water.json, then
    ``harmonic_frequencies`` and ``thermochemistry`` at the optimum. Gates:
    converged with max |g| < 3e-5, three vibrational modes, all real and
    above 1000 cm^-1. Returns the three frequencies."""
    system = load_system(Q, "water")
    cfg = Q.HartreeFockConfig(epsilon=1e-10, max_iterations=150, spin_multiplicity=1)
    reset(kernels)
    t0 = time.perf_counter()
    opt = Q.optimize_geometry(system, cfg, device="cuda")
    opt_s = time.perf_counter() - t0
    print(f"water/cc-pVDZ optimization: converged {opt.converged}, {opt.steps} steps, "
          f"E {opt.energy:.10f}, max |g| {opt.gradient_norm:.2e}, wall {opt_s:.2f} s", flush=True)
    print(f"  energies {opt.energies}", flush=True)
    print(f"  geometry {opt.positions.tolist()}", flush=True)
    if not (opt.converged and opt.gradient_norm < 3e-5):
        fail("the water/cc-pVDZ optimization did not converge below max |g| 3e-5")
    t0 = time.perf_counter()
    res = Q.harmonic_frequencies(system.with_positions(opt.positions), cfg, device="cuda")
    hess_s = time.perf_counter() - t0
    launches = launches_of(kernels)
    vib = [f for f in res.frequencies_cm1 if abs(f) >= 50.0]
    print(f"water/cc-pVDZ harmonic analysis: wall {hess_s:.2f} s (18 SCF + gradient runs), "
          f"n_zero_modes {res.n_zero_modes} (6 expected), all modes {res.frequencies_cm1}; "
          f"launches {launches}", flush=True)
    th = Q.thermochemistry(system.with_positions(opt.positions), res.frequencies_cm1,
                           symmetry_number=2)
    print(f"  thermochemistry (298.15 K, 1 atm, sigma 2): ZPE {th.zpe:.6f} Eh, H - E "
          f"{th.thermal_enthalpy:.6f} Eh, G - E {th.thermal_gibbs:.6f} Eh, S {th.entropy:.3f} "
          f"J/(mol K)", flush=True)
    if not (len(vib) == 3 and all(f > 1000.0 for f in vib)):
        fail(f"water/cc-pVDZ vibrations {vib} are not three real modes above 1000 cm^-1")
    if not (launches["eri_tile"] > 0 and launches["fock_matvec"] > 0):
        fail(f"the water optimization and Hessian bypassed a kernel: {launches}")
    paths["optimize + frequencies water incore"] = dict(
        launches, optimize_s=opt_s, steps=opt.steps, hessian_s=hess_s,
        n_zero_modes=res.n_zero_modes)
    return vib


def cli_run(cmd: list) -> list:
    """One CLI subprocess on the card: exit 0, its printed lines."""
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
    print(f"CLI {' '.join(cmd[1:])}: exit {proc.returncode} in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for line in proc.stdout.splitlines():
        print(f"  {line}", flush=True)
    if proc.returncode != 0:
        fail(f"the CLI's {cmd[3]} exited {proc.returncode}: {proc.stderr[-2000:]}")
    return proc.stdout.splitlines()


def cli_frequencies(vib: list) -> None:
    """The CLI's frequencies --opt-first --thermo on water/cc-pVDZ as a
    subprocess: the same three frequencies as the in-process run."""
    lines = cli_run([sys.executable, "-m", "qchem_rs_tpu_torch.cli", "frequencies", "-b",
                     "data/basis/cc-pVDZ.json", "-m", "data/mol/water.json", "--epsilon",
                     "1e-10", "--opt-first", "--thermo", "--symmetry-number", "2"])
    want = "harmonic frequencies (cm^-1): " + " ".join(f"{f:8.1f}" for f in vib)
    if want not in lines or not any(x.startswith("  zero-point energy:") for x in lines):
        fail(f"the CLI's frequencies did not print {want!r}")


def polarizabilities(Q, kernels: dict, paths: dict, benzene, naphthalene) -> None:
    """Static polarizabilities: benzene/cc-pVDZ in core and in pair space
    (equal within 1e-8, alpha_xx = alpha_yy within 1e-8, positive
    definite), naphthalene/cc-pVDZ in pair space (o*v = 5304)."""
    system, cfg, out = benzene
    alpha = {}
    for mode in ("incore", "pair"):
        run_cfg = Q.HartreeFockConfig(epsilon=1e-10, max_iterations=150, initial_guess="sad",
                                      fock_mode=mode)
        reset(kernels)
        alpha[mode] = timed(f"static polarizability benzene/cc-pVDZ {mode}",
                            lambda: Q.static_polarizability(system, run_cfg, output=out,
                                                            device="cuda"))
        launches = launches_of(kernels)
        print(f"  alpha {alpha[mode].tolist()}; launches {launches}", flush=True)
        if launches["eri_tile"] == 0:
            fail(f"the benzene polarizability in {mode} did not launch kernel 1")
        paths[f"polarizability benzene {mode}"] = launches
    a = alpha["incore"]
    gate("benzene polarizability: in core - pair", float(np.abs(a - alpha["pair"]).max()), 1e-8)
    gate("benzene polarizability: alpha_xx - alpha_yy", a[0, 0] - a[1, 1], 1e-8)
    if not np.all(np.linalg.eigvalsh(a) > 0):
        fail(f"the benzene polarizability is not positive definite: {a}")
    system, cfg, out = naphthalene
    reset(kernels)
    an = timed("static polarizability naphthalene/cc-pVDZ pair (o*v = 5304)",
               lambda: Q.static_polarizability(system, cfg, output=out, device="cuda"))
    launches = launches_of(kernels)
    print(f"  alpha {an.tolist()}, isotropic {np.trace(an) / 3.0:.6f}; launches {launches}",
          flush=True)
    if launches["eri_tile"] == 0 or not np.all(np.linalg.eigvalsh(an) > 0):
        fail("the naphthalene polarizability bypassed kernel 1 or is not positive definite")
    paths["polarizability naphthalene pair"] = launches


def cli_gradient_polarizability(Q) -> None:
    """The CLI's rhf --gradient --polarizability on water/cc-pVDZ as a
    subprocess: its gradient and polarizability lines equal the
    in-process values at their printed digits."""
    system = load_system(Q, "water")
    cfg = Q.HartreeFockConfig(epsilon=1e-10, spin_multiplicity=1)
    out = Q.restricted_hartree_fock(system, cfg, device="cuda")
    g = Q.rhf_gradient(system, cfg, output=out, device="cuda")
    alpha = Q.static_polarizability(system, cfg, output=out, device="cuda")
    lines = cli_run([sys.executable, "-m", "qchem_rs_tpu_torch.cli", "rhf", "-b",
                     "data/basis/cc-pVDZ.json", "-m", "data/mol/water.json", "--epsilon", "1e-10",
                     "--gradient", "--polarizability"])
    want = [f"  {a.ordinal:3d}  {r[0]: .8f} {r[1]: .8f} {r[2]: .8f}"
            for a, r in zip(system.atoms, g)]
    want += [f"static polarizability (a.u.), isotropic {float(np.trace(alpha) / 3.0):.6f}:"]
    want += [f"  {r[0]: .6f} {r[1]: .6f} {r[2]: .6f}" for r in alpha]
    missing = [w for w in want if w not in lines]
    if missing:
        fail(f"the CLI's rhf --gradient --polarizability did not print {missing}")


def benzene_conformers(Q):
    """(system, config, geometries): benzene/cc-pVDZ with its atoms scaled
    about their centre by 0.98, 1.00, 1.02 and 1.04, in core from Hückel
    to diag_rms 1e-11 (at 1e-10 the stop alone left a chained energy
    1.01e-9 Eh from the sweep's on an H100)."""
    system = load_system(Q, "benzene")
    pos = np.asarray(system.positions)
    centre = pos.mean(axis=0)
    geoms = np.stack([centre + s * (pos - centre) for s in (0.98, 1.0, 1.02, 1.04)])
    drift = float(np.linalg.norm(geoms - pos, axis=2).max())
    print(f"benzene/cc-pVDZ conformers: scales 0.98-1.04, largest atom drift {drift:.3f} Bohr "
          "from the file's geometry", flush=True)
    return system, Q.HartreeFockConfig(epsilon=1e-11, max_iterations=150), geoms


def conformer_sweep_phase(Q, kernels: dict, paths: dict):
    """The slice's main path: ``conformer_sweep`` over four benzene
    conformers on the one-device mesh, both kernels counted over it; each
    energy equal in bits to a ``restricted_hartree_fock`` run at that
    geometry. Returns (system, config, geometries, energies, launches,
    iterations of the single runs)."""
    from qchem_rs_tpu_torch.parallel.sweep import conformer_sweep

    system, cfg, geoms = benzene_conformers(Q)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset(kernels)
    t0 = time.perf_counter()
    energies, converged = conformer_sweep(system, geoms, cfg, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launches_of(kernels)
    peak = torch.cuda.max_memory_allocated()
    print(f"conformer_sweep benzene/cc-pVDZ x{len(geoms)} in core: energies "
          f"{[f'{e:.10f}' for e in energies]}, converged {converged.tolist()}, wall {wall:.4f} s "
          f"({wall / len(geoms):.4f} s a conformer), peak device memory {peak / 1e9:.3f} GB; "
          f"launches {launches}", flush=True)
    if not converged.all():
        fail("a benzene conformer did not converge in the sweep")
    if launches["eri_tile"] == 0 or launches["fock_matvec"] == 0:
        fail(f"the conformer sweep bypassed a kernel: {launches}")
    singles = [Q.restricted_hartree_fock(system.with_positions(g), cfg, device="cuda")
               for g in geoms]
    same = [e == o.total_energy() for e, o in zip(energies, singles)]
    print(f"conformer_sweep - single runs: bits equal {same}; iterations "
          f"{[o.iterations for o in singles]}", flush=True)
    if not all(same):
        fail("the conformer sweep's energies differ from single runs at the same geometries")
    paths["conformer sweep benzene incore"] = dict(launches, wall_s=wall, peak_bytes=peak)
    return system, cfg, geoms, energies, launches, [o.iterations for o in singles]


def chained_phase(Q, kernels: dict, paths: dict, sweep) -> np.ndarray:
    """``chained_sweep`` over the benzene conformers in core (each energy
    within 1e-9 of the sweep's; the chain's iterations against the single
    runs', a finding), and over naphthalene/cc-pVDZ scaled 1.00, 1.01,
    1.02 in pair and in direct mode from SAD to diag_rms 1e-12 (each
    within 1e-9 of a fresh run at that geometry). Returns the benzene
    chain's energies."""
    from qchem_rs_tpu_torch.parallel.sweep import chained_sweep, rhf_energy_fn

    system, cfg, geoms, energies, _, single_iterations = sweep
    reset(kernels)
    t0 = time.perf_counter()
    chain, converged = chained_sweep(system, geoms, cfg, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launches_of(kernels)
    # the same chain by hand, for its iteration counts
    fn, guess, iterations, again = rhf_energy_fn(system, cfg, "cuda"), None, [], []
    for g in geoms:
        total, _, it, density = fn(g, guess)
        guess = density
        iterations.append(it)
        again.append(total)
    gap = float(np.abs(chain - energies).max())
    print(f"chained_sweep benzene/cc-pVDZ in core: wall {wall:.4f} s, largest |chain - sweep| "
          f"{gap:.2e} Eh, iterations {iterations} (total {sum(iterations)}) against "
          f"{single_iterations} (total {sum(single_iterations)}) from Hückel; launches {launches}",
          flush=True)
    if not converged.all() or gap > 1e-9 or list(chain) != again:
        fail("the benzene chain misses the sweep's energies or its own repeat")
    paths["chained sweep benzene incore"] = dict(launches, wall_s=wall)
    naph = load_system(Q, "naphthalene")
    pos = np.asarray(naph.positions)
    centre = pos.mean(axis=0)
    ngeoms = np.stack([centre + s * (pos - centre) for s in (1.0, 1.01, 1.02)])
    for mode in ("pair", "direct"):
        # diag_rms 1e-12: at 1e-10 the stop alone left the pair chain 3.2e-9 Eh
        # from the fresh runs on an H100
        ncfg = Q.HartreeFockConfig(epsilon=1e-12, max_iterations=200, fock_mode=mode,
                                   initial_guess="sad")
        reset(kernels)
        t0 = time.perf_counter()
        nchain, nconv = chained_sweep(naph, ngeoms, ncfg, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = launches_of(kernels)
        fresh = [Q.restricted_hartree_fock(naph.with_positions(g), ncfg, device="cuda")
                 for g in ngeoms]
        gap = float(np.abs(nchain - [o.total_energy() for o in fresh]).max())
        print(f"chained_sweep naphthalene/cc-pVDZ {mode} x3: wall {wall:.4f} s, largest |chain - "
              f"fresh| {gap:.2e} Eh; fresh iterations {[o.iterations for o in fresh]}, fresh "
              f"total_s {sum(o.timings['total_s'] for o in fresh):.4f}; launches {launches}",
              flush=True)
        if not nconv.all() or gap > 1e-9:
            fail(f"the naphthalene {mode} chain misses the fresh runs' energies")
        if launches["eri_tile_values" if mode == "direct" else "eri_tile"] == 0:
            fail(f"the naphthalene {mode} chain bypassed its ERI kernel: {launches}")
        paths[f"chained sweep naphthalene {mode}"] = dict(launches, wall_s=wall)
    return chain


def scf_through(Q, system, cfg, builder) -> tuple:
    """The port's ``_rhf_scf`` from SAD with G = J - K/2 of ``builder``:
    (total energy, the SCF result)."""
    from qchem_rs_tpu_torch.models.rhf import _rhf_scf, core_hamiltonian
    from qchem_rs_tpu_torch.models.sad import sad_guess
    from qchem_rs_tpu_torch.utils import interop

    S, H, X, _ = core_hamiltonian(system, "cuda")
    D0 = interop.density_guess(sad_guess(system), system.n_basis(), 1, "cuda")

    def g_fn(D):
        J, K = builder.jk(D)
        return J - 0.5 * K

    st = _rhf_scf(H, X, S, system.n_electrons(0) // 2, cfg, g_fn, D0)
    return st.energy + system.nuclear_repulsion(), st


def nccl_phases(Q, kernels: dict, paths: dict, naphthalene) -> None:
    """The three sharded builders through a real NCCL group of size 1 on
    naphthalene/cc-pVDZ (M = 19136): J and K of the pair SCF density
    within 1e-12 relative of the unsharded pair builder's, an RHF through
    each (SAD, diag_rms 1e-10) within 1e-9 Eh of the pair run, the
    streaming builder's run repeated in equal bits, each builder's prepare
    and J/K time and peak memory; then MP2 through both sharded pair
    builders within 1e-9 of its anchor. The group is destroyed at the
    end."""
    import socket

    import torch.distributed as dist

    from qchem_rs_tpu_torch.ops.fock_pair import PairSpaceFockBuilder, PairSpaceShardedFockBuilder
    from qchem_rs_tpu_torch.parallel.fock_sharded import ShardedFockBuilder
    from qchem_rs_tpu_torch.parallel.mesh import data_mesh
    from qchem_rs_tpu_torch.parallel.v2_sharded import ColumnShardedPairFockBuilder

    system, cfg, out = naphthalene
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", world_size=1, rank=0)
    try:
        mesh = data_mesh(device="cuda")
        print(f"NCCL group: backend {dist.get_backend()}, size {mesh.size}, device {mesh.device}",
              flush=True)
        D = torch.as_tensor(out.density, device="cuda")
        J_ref, K_ref = PairSpaceFockBuilder(system, 1e-12, device="cuda").jk(D)
        scf_cfg = Q.HartreeFockConfig(epsilon=1e-10, max_iterations=200)
        for name, cls in (("ShardedFockBuilder", ShardedFockBuilder),
                          ("PairSpaceShardedFockBuilder", PairSpaceShardedFockBuilder),
                          ("ColumnShardedPairFockBuilder", ColumnShardedPairFockBuilder)):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset(kernels)
            t0 = time.perf_counter()
            builder = cls(system, mesh, 1e-12)
            if hasattr(builder, "prepare"):
                builder.prepare()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            J, K = builder.jk(D)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            builder.jk(D)
            torch.cuda.synchronize()
            warm = time.perf_counter() - t2
            t2 = time.perf_counter()
            dJ, dK = rel_err(J, J_ref)[1], rel_err(K, K_ref)[1]
            e, st = scf_through(Q, system, scf_cfg, builder)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            launches = launches_of(kernels)
            peak = torch.cuda.max_memory_allocated()
            dE = e - out.total_energy()
            print(f"{name} over NCCL (1 rank): prepare {t1 - t0:.4f} s, J/K {t2 - t1 - warm:.4f} s "
                  f"first, {warm:.4f} s again, "
                  f"RHF {t3 - t2:.4f} s ({st.passes - 1} iterations, E {e:.10f}, dE {dE:.2e} "
                  f"from the pair run); J, K rel. err {dJ:.2e}, {dK:.2e}; peak device memory "
                  f"{peak / 1e9:.3f} GB; launches {launches}", flush=True)
            kernel = "eri_tile_values" if cls is ShardedFockBuilder else "eri_tile"
            if not st.converged or max(dJ, dK) > 1e-12 or abs(dE) > 1e-9 or launches[kernel] == 0:
                fail(f"{name} over NCCL misses the unsharded J/K or energy")
            paths[f"nccl {name} naphthalene"] = dict(launches, prepare_s=t1 - t0, jk_s=warm,
                                                     rhf_s=t3 - t2, peak_bytes=peak)
            if cls is ShardedFockBuilder:
                e2, st2 = scf_through(Q, system, scf_cfg, builder)
                same = e2 == e and torch.equal(st2.density, st.density)
                print(f"{name} RHF twice: energy and density bits equal {same}", flush=True)
                if not same:
                    fail("two sharded direct RHF runs differ")
            del builder
        for cls in (PairSpaceShardedFockBuilder, ColumnShardedPairFockBuilder):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset(kernels)
            res = Q.mp2_pair_space(system, cfg, output=out, device="cuda",
                                   builder=cls(system, mesh, 1e-12))
            torch.cuda.synchronize()
            launches = launches_of(kernels)
            d = res.correlation_energy - NAPHTHALENE_MP2_CORR
            print(f"MP2 naphthalene/cc-pVDZ through {cls.__name__} over NCCL: correlation "
                  f"{res.correlation_energy:.12f} ({d:.2e} from the anchor), eri_s "
                  f"{res.timings['eri_s']:.4f}, transform_s {res.timings['transform_s']:.4f}, "
                  f"peak device memory {torch.cuda.max_memory_allocated() / 1e9:.3f} GB; launches "
                  f"{launches}", flush=True)
            if abs(d) > 1e-9 or launches["eri_tile"] == 0:
                fail(f"sharded MP2 through {cls.__name__} misses its anchor")
    finally:
        dist.destroy_process_group()


def rank_view_phases(Q, naphthalene) -> None:
    """Rank views of 4 and 3 on the one card, naphthalene/cc-pVDZ: the
    streaming builder's shares add up (in rank order) to the unsharded
    direct J/K; the column builder's slabs, placed through colperm, are
    the mirrored V2f with every padding column unwritten; the pair
    builder's slabs are V2f's and W's columns in equal bits (3 ranks do
    not divide M: shares of unequal width)."""
    from qchem_rs_tpu_torch.ops.eri_tiled import TiledEriEngine
    from qchem_rs_tpu_torch.ops.fock_pair import PairSpaceFockBuilder, PairSpaceShardedFockBuilder
    from qchem_rs_tpu_torch.ops.fock_stream import StreamingFockBuilder
    from qchem_rs_tpu_torch.parallel.fock_sharded import ShardedFockBuilder
    from qchem_rs_tpu_torch.parallel.mesh import rank_view
    from qchem_rs_tpu_torch.parallel.v2_sharded import ColumnShardedPairFockBuilder

    system, _, out = naphthalene
    D = torch.as_tensor(out.density, device="cuda")
    engine = TiledEriEngine(system, 1e-12, device="cuda")
    J_ref, K_ref = StreamingFockBuilder(system, 1e-12, device="cuda", engine=engine).jk(D)
    pair = PairSpaceFockBuilder(system, 1e-12, device="cuda", engine=engine, lean=False)
    V2f, W = pair.prepare()
    for size in (4, 3):
        views = [ShardedFockBuilder(system, rank_view(size, r), 1e-12, engine=engine)
                 for r in range(size)]
        J = K = 0.0
        for view in views:
            Jr, Kr = view.jk_partial(D)
            J, K = J + Jr, K + Kr
        dJ, dK = rel_err(J, J_ref)[1], rel_err(K, K_ref)[1]
        print(f"ShardedFockBuilder, {size} rank views: tiles {[sum(len(b[2]) for b in v.batches) for v in views]}; "
              f"J, K rel. err {dJ:.2e}, {dK:.2e}", flush=True)
        if max(dJ, dK) > 1e-12:
            fail(f"{size} streaming rank views do not add up to the direct J/K")
        scale = float(V2f.abs().max())
        worst, unwritten = 0.0, True
        for r in range(size):
            view = ColumnShardedPairFockBuilder(system, rank_view(size, r), 1e-12, engine=engine)
            t0 = time.perf_counter()
            slab = view.v2f_slab()
            torch.cuda.synchronize()
            own = torch.as_tensor(view.colperm[r] >= 0, device="cuda")
            cols = torch.as_tensor(view.colperm[r][view.colperm[r] >= 0], device="cuda")
            if cols.numel():
                worst = max(worst, float((slab[:, own] - V2f[:, cols]).abs().max()) / scale)
            unwritten = unwritten and not bool(slab[:, ~own].any())
            print(f"ColumnShardedPairFockBuilder rank {r} of {size}: slab {tuple(slab.shape)}, "
                  f"{int(own.sum())} live columns, load {view.loads[r]:.4e} FLOP, build "
                  f"{time.perf_counter() - t0:.4f} s", flush=True)
            del slab
        print(f"ColumnShardedPairFockBuilder, {size} rank views: slabs - V2f rel. err "
              f"{worst:.2e}; padding columns unwritten {unwritten}", flush=True)
        if worst > 1e-12 or not unwritten:
            fail(f"{size} column rank views do not reassemble V2f")
    for size in (4, 3):  # 3 does not divide M: shares of unequal width
        for r in range(size):
            view = PairSpaceShardedFockBuilder(system, rank_view(size, r), 1e-12, engine=engine)
            slab, Wc = view.prepare()
            same = torch.equal(slab, V2f[:, view.cols]) and torch.equal(Wc, W[:, view.cols])
            print(f"PairSpaceShardedFockBuilder rank {r} of {size}: columns {view.cols.start}-"
                  f"{view.cols.stop}, V2f and W columns bits equal {same}", flush=True)
            if not same:
                fail("a pair rank view's slabs are not V2f's and W's columns")
            del slab, Wc, view


def cli_sweep(geoms: np.ndarray, energies: np.ndarray, chain: np.ndarray) -> None:
    """The CLI's sweep and sweep --chain on the benzene conformers, as
    subprocesses: their conformer lines equal the in-process energies as
    printed."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "conformers.json")
        with open(path, "w") as f:
            json.dump(geoms.tolist(), f)
        for flags, values in (([], energies), (["--chain"], chain)):
            lines = cli_run([sys.executable, "-m", "qchem_rs_tpu_torch.cli", "sweep", "-b",
                             "data/basis/cc-pVDZ.json", "-m", "data/mol/benzene.json", "-g", path,
                             "--epsilon", "1e-11", "--max-iterations", "150", *flags])
            want = [f"conformer {i}: {e:.8f}" for i, e in enumerate(values)]
            if lines[1:] != want:
                fail(f"the CLI's sweep {flags} printed {lines[1:]}, not {want}")


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    import qchem_rs_tpu_torch as Q
    from qchem_rs_tpu_torch.ops import eri_kernel, fock_matvec
    from qchem_rs_tpu_torch.ops.angular import ncart
    from qchem_rs_tpu_torch.ops.eri_tiled import TiledEriEngine
    from qchem_rs_tpu_torch.utils.cuda import load_all

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    # 1. build both kernels from the checkout's sources
    kernels = (eri_kernel.KERNEL, eri_kernel.HIGHL_KERNEL, eri_kernel.BOYS_PROBE,
               eri_kernel.VALUES_KERNEL, eri_kernel.VALUES_HIGHL_KERNEL, fock_matvec.KERNEL)
    t0 = time.perf_counter()
    load_all(list(kernels))
    print(f"kernel build: {time.perf_counter() - t0:.1f} s", flush=True)
    print_ptxas(eri_kernel.KERNEL)
    print_ptxas(eri_kernel.HIGHL_KERNEL)
    print_ptxas(eri_kernel.VALUES_KERNEL)
    print_ptxas(eri_kernel.VALUES_HIGHL_KERNEL)
    print_ptxas(fock_matvec.KERNEL)

    # 2. each kernel against its twin
    k1_abs, highl_abs = check_kernel1(eri_kernel, ncart)
    highl_abs = max(highl_abs, check_highl_shapes(eri_kernel, ncart))
    k3_abs = check_kernel3(eri_kernel, ncart)
    k3h_abs = check_values_highl(eri_kernel, ncart)
    check_boys(eri_kernel)
    k2 = check_kernel2(fock_matvec)

    # 3. water/cc-pVDZ against its anchor
    _, _, out, wall = run_rhf(Q, "water", 1e-10, 100)
    dE = out.total_energy() - WATER_E
    print(f"water/cc-pVDZ: E {out.total_energy():.10f} (dE {dE:.2e}), "
          f"{out.iterations} iterations, converged {out.converged}, {wall:.2f} s", flush=True)
    if not (out.converged and abs(dE) <= 1e-8):
        fail("water/cc-pVDZ misses its anchor")
    _, _, out, wall = run_rhf(Q, "water", 1e-10, 100, spherical=True)
    dE = out.total_energy() - WATER_SPH_E
    print(f"water/cc-pVDZ spherical: E {out.total_energy():.10f} (dE {dE:.2e} from the JAX CPU "
          f"value), {out.iterations} iterations, converged {out.converged}, {wall:.2f} s", flush=True)
    if not (out.converged and abs(dE) <= 1e-8):
        fail("water/cc-pVDZ spherical misses the JAX package's value")

    # 4. the headline: benzene/cc-pVDZ at diag_rms 1e-8, counting launches
    for k in kernels:
        k.launches = 0
    system, cfg, out, wall = run_rhf(Q, "benzene", 1e-8, 150)
    launches = {"eri_tile": eri_kernel.KERNEL.launches, "fock_matvec": fock_matvec.KERNEL.launches}
    tm = out.timings
    dE = out.total_energy() - BENZENE_E
    dE_card = out.total_energy() - BENZENE_E_CARD
    engine = TiledEriEngine(system, 1e-12, device="cuda")
    flops = engine.analytic_build_flops()
    setup_s = tm["total_s"] - tm["one_electron_s"] - tm["eri_s"] - tm["scf_s"]
    print(f"benzene/cc-pVDZ: E {out.total_energy():.10f} (dE {dE:.2e} from the anchor, "
          f"{dE_card:.2e} from the earlier H100 value), {out.iterations} iterations, "
          f"converged {out.converged}", flush=True)
    print(f"benzene/cc-pVDZ timings: one_electron_s {tm['one_electron_s']:.4f}, "
          f"eri_s {tm['eri_s']:.4f}, scf_s {tm['scf_s']:.4f}, engine setup {setup_s:.4f}, "
          f"total_s {tm['total_s']:.4f}, wall {wall:.4f}; analytic build {flops / 1e9:.1f} GFLOP "
          f"-> {flops / tm['eri_s'] / 1e9:.1f} GFLOP/s", flush=True)
    print(f"benzene/cc-pVDZ launches: {launches}", flush=True)
    if not (out.converged and abs(dE) <= 1e-6 and abs(dE_card) <= 1e-9):
        fail("benzene/cc-pVDZ did not converge to its anchor")
    if not all(v > 0 for v in launches.values()):
        fail(f"the benzene run bypassed a kernel: {launches}")
    benzene = out
    _, _, out, _ = run_rhf(Q, "benzene", 1e-8, 150)
    tm = out.timings
    print(f"benzene/cc-pVDZ warm again: total_s {tm['total_s']:.4f}, one_electron_s "
          f"{tm['one_electron_s']:.4f}, eri_s {tm['eri_s']:.4f}, scf_s {tm['scf_s']:.4f}",
          flush=True)
    check_repeat("benzene/cc-pVDZ incore huckel", benzene, out)
    benzene_checkpoint(Q, system)

    # 5. kernel 1 against its twin at the benzene shapes, and timed
    k1 = time_kernel1(engine, eri_kernel)
    time_engine_setup(system)
    if "--profile" in argv:
        device_profile("benzene", lambda: Q.restricted_hartree_fock(system, cfg, device="cuda"))

    # 6. the scale path: naphthalene/cc-pVDZ through every Fock mode, the
    # kernels on its new paths, and UHF at BASELINE config 3
    named = {"eri_tile": eri_kernel.KERNEL, "eri_tile_highl": eri_kernel.HIGHL_KERNEL,
             "eri_tile_values": eri_kernel.VALUES_KERNEL,
             "eri_tile_values_highl": eri_kernel.VALUES_HIGHL_KERNEL, "fock_matvec": fock_matvec.KERNEL}
    paths = {"rhf benzene incore huckel": dict(launches)}
    naph, pair_run = naphthalene_rhf(Q, named, paths)
    pair_kernel_numbers(naph, pair_run.density, fock_matvec)
    k3 = direct_pass_numbers(naph, pair_run.density, eri_kernel, profile="--profile" in argv)
    uhf_6_31g(Q, named, paths)

    # 7. every basis: spherical AOs through every mode, f shells through the
    # high-L part
    naphthalene_spherical(Q, named, paths)
    uhf_spherical(Q, named, paths)
    fc_system, fc_launches, fc_pair = ferrocene(Q, named, paths)
    hl = time_highl(fc_system, eri_kernel)
    k3h = ferrocene_direct_numbers(fc_system, fc_pair.density, eri_kernel)
    zinc_atom(Q, named, paths)

    # 8. the SCF options at full size, MP2 in both ERI forms, the CLI
    water_field(Q, named, paths)
    naphthalene = mp2_runs(Q, named, paths)
    cli_mp2()

    # 9. the correlated tier past MP2: CCSD(T), UCCSD(T), CIS/TDHF/UCIS, FCI,
    # EOM-CCSD, CC dipoles and the CLI's ccsd
    benzene_hf = benzene_ccsd_t(Q, named, paths)
    water_ccsd_t(Q, named, paths)
    uccsd_t(Q, named, paths)
    cis_runs(Q, named, paths, naphthalene, benzene_hf)
    fci_water(Q)
    eom_runs(Q, named, paths)
    cc_dipoles(Q)
    cli_ccsd()

    # 10. the gradient and geometry tier: the benzene gradient (in core, pair),
    # UHF OH, the water optimization and frequencies, the polarizabilities,
    # and the CLI's frequencies and rhf --gradient --polarizability
    benzene_grad = benzene_gradient(Q, named, paths)
    uhf_gradient_oh(Q, named, paths)
    cli_frequencies(water_frequencies(Q, named, paths))
    polarizabilities(Q, named, paths, benzene_grad, naphthalene)
    cli_gradient_polarizability(Q)
    post_hf_launches = paths["rhf + ccsd(t) benzene incore sad"]
    grad_launches = paths["rhf + gradient benzene incore sad"]

    # 11. the multi-device tier: the conformer sweep (this slice's main
    # path) and the chained sweeps, the sharded builders through a real
    # NCCL group of one rank and as rank views on the one card, sharded
    # MP2, and the CLI's sweep
    walls = [time.perf_counter()]
    sweep = conformer_sweep_phase(Q, named, paths)
    sweep_launches = sweep[4]
    walls.append(time.perf_counter())
    chain = chained_phase(Q, named, paths, sweep)
    walls.append(time.perf_counter())
    nccl_phases(Q, named, paths, naphthalene)
    walls.append(time.perf_counter())
    rank_view_phases(Q, naphthalene)
    walls.append(time.perf_counter())
    cli_sweep(sweep[2], sweep[3], chain)
    walls.append(time.perf_counter())
    print("multi-device tier: " + ", ".join(
        f"{name} {b - a:.1f} s" for name, a, b in zip(
            ("sweep", "chains", "NCCL builders and MP2", "rank views", "CLI sweep"),
            walls, walls[1:])) + f"; {walls[-1] - walls[0]:.1f} s in all", flush=True)
    print(f"chip_smoke wall: {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"paths": paths}), flush=True)

    print(json.dumps({"kernels": [
        {"name": "eri_tile", "route": "cuda", "source": "qchem_rs_tpu_torch/csrc/eri_tile.cu",
         "replaces": "qchem_rs_tpu/ops/eri_pallas.py:205", "launches": launches["eri_tile"],
         "launches_per_run": launches["eri_tile"],
         "launches_rhf_ccsd_t": post_hf_launches["eri_tile"],
         "launches_rhf_gradient": grad_launches["eri_tile"],
         "launches_sweep": sweep_launches["eri_tile"],
         "max_abs_err": max(k1_abs, k1["max_abs_err"]),
         "ms": k1["ms"], "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"],
         "bound_by": k1["bound_by"], "library_ms": k1["library_ms"]},
        {"name": "eri_tile_highl", "route": "cuda",
         "source": "qchem_rs_tpu_torch/csrc/eri_tile_highl.cu",
         "replaces": "qchem_rs_tpu/ops/eri_pallas.py:205 and :175 for L <= 8; beyond, the XLA f64 "
                     "fallback of qchem_rs_tpu/ops/eri_tiled.py:638",
         "launches": fc_launches["eri_tile_highl"], "launches_per_run": fc_launches["eri_tile_highl"],
         "max_abs_err": max(highl_abs, hl["max_abs_err"]), "ms": hl["ms"], "device_ms": hl["device_ms"],
         "plain_ms": hl["plain_ms"],
         "bound_ms": hl["bound_ms"], "bound_by": hl["bound_by"], "library_ms": hl["library_ms"]},
        {"name": "tile_values", "route": "cuda",
         "source": "qchem_rs_tpu_torch/csrc/eri_tile_values.cu",
         "replaces": "qchem_rs_tpu/ops/eri_pallas.py:175 and :191 with the contractions of "
                     "tile_vals_pallas :430",
         "launches": paths["rhf naphthalene direct sad"]["eri_tile_values"],
         "launches_per_run": paths["rhf naphthalene direct sad"]["eri_tile_values"],
         "launches_per_pass": k3["launches_per_pass"],
         "launches_sweep_chain": paths["chained sweep naphthalene direct"]["eri_tile_values"],
         "max_abs_err": max(k3_abs, k3["max_abs_err"]), "ms": k3["ms"], "plain_ms": k3["plain_ms"],
         "bound_ms": k3["bound_ms"], "bound_by": k3["bound_by"], "library_ms": k3["library_ms"],
         "old_route_ms": k3["old_route_ms"]},
        {"name": "tile_values_highl", "route": "cuda",
         "source": "qchem_rs_tpu_torch/csrc/eri_tile_values_highl.cu",
         "replaces": "qchem_rs_tpu/ops/eri_pallas.py:175 and :191 with the contractions of "
                     "tile_vals_pallas :430 for L <= 8; beyond, the XLA f64 path of "
                     "qchem_rs_tpu/ops/fock_stream.py:109-113",
         "launches": paths["rhf ferrocene direct sad"]["eri_tile_values_highl"],
         "launches_per_run": paths["rhf ferrocene direct sad"]["eri_tile_values_highl"],
         "launches_per_pass": k3h["launches_per_pass"],
         "max_abs_err": max(k3h_abs, k3h["max_abs_err"]), "ms": k3h["ms"],
         "device_ms": k3h["device_ms"], "plain_ms": k3h["plain_ms"], "bound_ms": k3h["bound_ms"],
         "bound_by": k3h["bound_by"], "library_ms": k3h["library_ms"],
         "old_route_ms": k3h["old_route_ms"]},
        {"name": "fock_matvec", "route": "cuda",
         "source": "qchem_rs_tpu_torch/csrc/fock_matvec.cu",
         "replaces": "qchem_rs_tpu/ops/fock_matvec.py:82", "launches": launches["fock_matvec"],
         "launches_per_run": launches["fock_matvec"],
         "launches_rhf_ccsd_t": post_hf_launches["fock_matvec"],
         "launches_rhf_gradient": grad_launches["fock_matvec"],
         "launches_sweep": sweep_launches["fock_matvec"], "max_abs_err": k2["max_abs_err"],
         "ms": k2["ms"], "plain_ms": k2["plain_ms"], "bound_ms": k2["bound_ms"],
         "bound_by": k2["bound_by"], "library_ms": k2["library_ms"]},
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
