"""Unrestricted Hartree-Fock as a host loop on a leading spin axis (port of
``qchem_rs_tpu/models/uhf.py``).

Algorithmic parity with the reference (qchem-rs core/src/hf/uhf.rs:36-241):
per-spin G^s = J(D^a + D^b) - K(D^s) (uhf.rs:210-227), both spins' Fock
matrices from the pre-update densities, per-spin DIIS(2,8) (uhf.rs:76-78),
energy sum_s 1/2 Tr[D^s_new (2H + G^s_old)] (uhf.rs:140-161), and the
convergence quirk under "diag_rms": the per-spin diagonal RMS averaged
over spins, then halved again in the test (uhf.rs:137-139). Spin
multiplicity 0 splits the electrons n/2-n/2 (uhf.rs:43-45).

Three Fock modes, as in RHF:

- "incore": the (n, n, n, n) tensor from ``TiledEriEngine.finish_eri``;
  J is kernel 2 on its (n^2, n^2) matrix, which is symmetric, and K the
  row scan K^s_ij = sum_kl (ik|jl) D^s_kl over AO rows i;
- "pair": J and K per spin from the pair-space matrices;
- "direct": one recomputation of the integrals digests both spins
  (``StreamingFockBuilder.jk_stack``).

A spherical system runs every mode in its working (spherical) basis. Level
shifting and a uniform external field run in every mode, as in RHF.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Optional

import numpy as np
import torch

from qchem_rs_tpu_torch.config import HartreeFockConfig
from qchem_rs_tpu_torch.models import scf
from qchem_rs_tpu_torch.models.diis import Diis
from qchem_rs_tpu_torch.models.rhf import (
    _check_config,
    _sync,
    check_device,
    check_occupied,
    core_hamiltonian,
)
from qchem_rs_tpu_torch.ops import fock_matvec, one_electron
from qchem_rs_tpu_torch.ops.eri_tiled import TiledEriEngine
from qchem_rs_tpu_torch.ops.fock_pair import PairSpaceFockBuilder
from qchem_rs_tpu_torch.ops.fock_stream import StreamingFockBuilder
from qchem_rs_tpu_torch.utils import interop
from qchem_rs_tpu_torch.utils.system import MolecularSystem


@dataclasses.dataclass
class UnrestrictedHartreeFockOutput:
    """Mirrors UnrestrictedHartreeFockOutput (uhf.rs:15-34), with extras."""

    orbital_energies_alpha: np.ndarray
    orbital_energies_beta: np.ndarray
    electronic_energy: float
    nuclear_repulsion: float
    iterations: int
    converged: bool
    density: np.ndarray  # (2, n, n)
    coefficients: np.ndarray  # (2, n, n)
    timings: dict

    def total_energy(self) -> float:
        return self.electronic_energy + self.nuclear_repulsion


@dataclasses.dataclass
class _UhfResult:
    passes: int
    density: torch.Tensor
    energy: float
    converged: bool
    orbital_energies: torch.Tensor
    coefficients: torch.Tensor


def _uhf_value(metric: str, *, energy, prev_energy, prev_rms, err, d_change, epsilon):
    """(value, converged) of one pass under ``metric``, as the JAX package's
    ``_uhf_loop`` computes them."""
    if metric == "energy":
        rms = abs(energy - prev_energy)
        return rms, rms < epsilon
    if metric in ("diis_err", "diis_err2"):
        rms = float(err.abs().max())
        conv = rms < epsilon
        return rms, conv and (not metric.endswith("2") or prev_rms < epsilon)
    per_spin = [float(scf.density_rms(d, "diag_rms" if metric.startswith("composite")
                                      else metric.removesuffix("2"))) for d in d_change]
    if metric.startswith("composite"):
        de = abs(energy - prev_energy)
        rms = de if sum(per_spin) / 2.0 < scf.composite_guard(metric) else math.inf
        return rms, rms < epsilon and prev_rms < epsilon
    if metric == "diag_rms":
        rms = sum(per_spin) / 2.0  # uhf.rs:137-139: the spin mean, halved again below
        return rms, rms / 2.0 < epsilon
    rms = sum(per_spin) / 2.0
    return rms, rms < epsilon and (not metric.endswith("2") or prev_rms < epsilon)


def _uhf_scf(H, X, S, nocc: tuple[int, int], config: HartreeFockConfig, jk_fn, D0=None) -> _UhfResult:
    """The UHF fixed point from ``D0`` (2, n, n), Hückel's per-spin guess
    when None; ``jk_fn(D) -> (J_total (n, n), K (2, n, n))``."""
    n = H.shape[0]
    dev = H.device
    diis_min, diis_max = config.diis_window(2, 8)
    diis = [Diis(diis_max, diis_min, n, dev) for _ in range(2)]
    occ = torch.stack([torch.arange(n, device=dev) < k for k in nocc]).to(H.dtype)  # (2, n)
    if D0 is None:
        D0 = torch.stack([scf.huckel_guess(H, S, X, k, scale=1.0) for k in nocc])
    D = D0
    energy, rms, converged, passes = 0.0, math.inf, False, 0
    w = torch.zeros((2, n), dtype=H.dtype, device=dev)
    C = torch.zeros((2, n, n), dtype=H.dtype, device=dev)
    while not converged and passes <= config.max_iterations:
        J, K = jk_fn(D)
        G = J[None] - K  # uhf.rs:210-227
        F = H[None] + G
        err = F @ D @ S[None] - S[None] @ D @ F
        F = torch.stack([diis[s].apply(err[s], F[s]) for s in range(2)])
        if config.level_shift != 0.0:
            # the spin density carries no factor 2: it is the occupied projector
            solves = [scf.shifted_solve_fock(F[s], D[s], X, S, config.level_shift) for s in range(2)]
        else:
            solves = [scf.solve_fock(F[s], X) for s in range(2)]
        C, w = (torch.stack(x) for x in zip(*solves))
        D_new = torch.einsum("sik,sk,sjk->sij", C, occ, C)
        d_change = D_new - D
        D = D + config.mixing_factor * d_change
        new_energy = float(0.5 * torch.sum(D * (2.0 * H[None] + G)))  # uhf.rs:145-153
        rms, converged = _uhf_value(
            config.convergence_metric, energy=new_energy, prev_energy=energy, prev_rms=rms,
            err=err, d_change=d_change, epsilon=config.epsilon,
        )
        if config.verbose:
            print(f"iteration {passes} - density rms {rms:03.3e}")
        energy = new_energy
        passes += 1
    return _UhfResult(passes, D, energy, converged, w, C)


def jk_operator(system: MolecularSystem, config: HartreeFockConfig, device,
                timings: Optional[dict] = None):
    """(engine, jk_fn) of the configured Fock mode on ``device``: jk_fn(D)
    of per-spin densities D (2, n, n) is (J of the total density, K per
    spin (2, n, n)) in the working basis. In core the (n, n, n, n) tensor
    is built here (kernel 1) and J is kernel 2 on it; the pair mode builds
    V2f and W here; the direct mode digests both spins in one pass of
    kernel 1 per call. The build's time goes into ``timings["eri_s"]``."""
    timings = {} if timings is None else timings
    thr = config.screening_threshold
    n = system.n_basis()
    if config.fock_mode == "incore":
        engine = TiledEriEngine(system, thr, device=device)
        t1 = time.perf_counter()
        e4 = engine.finish_eri(engine.build())
        _sync(device)
        timings["eri_s"] = time.perf_counter() - t1
        eri_mat = e4.reshape(n * n, n * n)

        def jk_fn(D):
            J = fock_matvec.matvec(eri_mat, (D[0] + D[1]).reshape(-1)).reshape(n, n)
            K = torch.empty_like(D)
            for i in range(n):  # K^s_ij = sum_kl (ik|jl) D^s_kl; e4[i] is [k, j, l]
                K[:, i] = torch.einsum("kjl,skl->sj", e4[i], D)
            return J, K

        return engine, jk_fn
    if config.fock_mode == "pair":
        builder = PairSpaceFockBuilder(system, thr, device=device)
        t1 = time.perf_counter()
        builder.prepare()
        _sync(device)
        timings["eri_s"] = time.perf_counter() - t1

        def jk_fn(D):
            (Ja, Ka), (Jb, Kb) = builder.jk(D[0]), builder.jk(D[1])
            return Ja + Jb, torch.stack([Ka, Kb])
    else:
        builder = StreamingFockBuilder(system, thr, device=device)

        def jk_fn(D):
            Js, Ks = builder.jk_stack(D)  # one recomputation for both spins
            return Js[0] + Js[1], Ks

    return builder.engine, jk_fn


def unrestricted_hartree_fock(
    system: MolecularSystem,
    config: Optional[HartreeFockConfig] = None,
    *,
    density_guess: Optional[np.ndarray] = None,
    device="cuda",
) -> UnrestrictedHartreeFockOutput:
    """Run UHF on ``device`` (reference entry point uhf.rs:36-39), with
    charge and spin multiplicity honoured (multiplicity 0 is the
    reference's n/2-n/2 split). Defaults to the card and raises without
    CUDA, as ``restricted_hartree_fock``; ``density_guess`` (numpy
    (2, nao, nao)) starts the SCF in place of the configured guess."""
    config = config or HartreeFockConfig()
    _check_config(config)
    if config.convergence_metric.startswith("espan"):
        raise ValueError("espan is implemented for the RHF loops only")
    nocc = scf.electron_counts(system.n_electrons(config.charge), config.spin_multiplicity)
    device = check_device(device)
    n = system.n_basis()  # the working basis (spherical for a spherical system)
    check_occupied(max(nocc), n)

    timings: dict = {}
    if density_guess is None and config.initial_guess == "sad":
        from qchem_rs_tpu_torch.models.sad import sad_guess

        t_g = time.perf_counter()
        # split the total SAD density by the spin fractions, so that
        # Tr[D_sigma S] is about nocc_sigma
        D_tot = sad_guess(system, charge=config.charge)
        frac_a = nocc[0] / max(1, sum(nocc))
        density_guess = np.stack([frac_a * D_tot, (1.0 - frac_a) * D_tot])
        timings["guess_s"] = time.perf_counter() - t_g
    D0 = None if density_guess is None else interop.density_guess(density_guess, n, 2, device)
    t0 = time.perf_counter()
    if config.fock_mode == "incore":
        t1 = time.perf_counter()
        S, H, X, e_field = core_hamiltonian(system, device, config.electric_field)
        _sync(device)
        timings["one_electron_s"] = time.perf_counter() - t1
    else:
        S, H, X, e_field = core_hamiltonian(system, device, config.electric_field)
    _, jk_fn = jk_operator(system, config, device, timings)
    t1 = time.perf_counter()
    st = _uhf_scf(H, X, S, nocc, config, jk_fn, D0)
    _sync(device)
    timings["scf_s"] = time.perf_counter() - t1
    timings["total_s"] = time.perf_counter() - t0
    return UnrestrictedHartreeFockOutput(
        orbital_energies_alpha=st.orbital_energies[0].cpu().numpy(),
        orbital_energies_beta=st.orbital_energies[1].cpu().numpy(),
        electronic_energy=st.energy,
        nuclear_repulsion=system.nuclear_repulsion() + e_field,
        iterations=st.passes - 1,
        converged=st.converged,
        density=st.density.cpu().numpy(),
        coefficients=st.coefficients.cpu().numpy(),
        timings=timings,
    )


def spin_expectation(system: MolecularSystem, coefficients: np.ndarray, n_alpha: int,
                     n_beta: int) -> tuple[float, float]:
    """UHF <S^2> = S_z (S_z + 1) + N_beta - sum_ij |<phi_i^a|phi_j^b>|^2 over
    occupied orbitals, and its excess over the exact S_z (S_z + 1) (port of
    ``qchem_rs_tpu/models/properties.py::spin_expectation``)."""
    S = one_electron.overlap(system, "cpu").numpy()
    C = np.asarray(coefficients)
    ov = C[0][:, :n_alpha].T @ S @ C[1][:, :n_beta]
    sz = 0.5 * (n_alpha - n_beta)
    s2 = sz * (sz + 1.0) + n_beta - float((ov**2).sum())
    return s2, s2 - sz * (sz + 1.0)
