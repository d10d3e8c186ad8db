"""Restricted Hartree-Fock as a host loop on tensors (port of
``qchem_rs_tpu/models/rhf.py::restricted_hartree_fock``, its in-core
``_rhf_scf``, pair-space ``_rhf_scf_direct`` and streaming
``_rhf_scf_hostloop``).

Algorithmic parity with the reference (qchem-rs core/src/hf/rhf.rs:32-181):
nuclear repulsion (rhf.rs:110-122), H = T + V (rhf.rs:48), Löwdin X
(rhf.rs:124-131), Hückel guess (rhf.rs:133-150), DIIS(4,6) (rhf.rs:65), the
FDS-SDF error (rhf.rs:71), E = 1/2 Tr[D(2H + G)] with the *updated*
density but the *pre-update* G (rhf.rs:84-85), max_iterations+1 passes
(rhf.rs:66) and the 0-based reported iteration.

The three Fock modes share one loop and differ in G:

- "incore": the operator (ij|kl) - 1/2 (ik|jl) (rhf.rs:58-62) held as one
  (n^2, n^2) matrix, so G is one matvec (kernel 2, ``ops/fock_matvec.py``);
- "pair": G = J - 1/2 K from the pair-space matrices (``ops/fock_pair.py``);
- "direct": G = J - 1/2 K recomputed from the integrals at every pass
  (``ops/fock_stream.py``).

``initial_guess="sad"`` or a ``density_guess`` start the loop from another
density than Hückel's. ``level_shift`` shifts the virtual space in every
eigensolve (``scf.shifted_solve_fock``), and ``electric_field`` adds a
uniform external field to H and to the nuclear energy (``_field_terms``),
in every mode. A spherical system (``MolecularSystem(...,
spherical=True)``) runs every mode in its working basis: S, H, X, D, DIIS
and the orbitals are nsph-sized, and each Fock mode projects its Cartesian
integrals (``finish_terms``, or the builders' ``jk`` sandwiches).
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
from qchem_rs_tpu_torch.ops import fock_matvec, one_electron
from qchem_rs_tpu_torch.ops.eri_tiled import TiledEriEngine
from qchem_rs_tpu_torch.ops.fock_pair import PairSpaceFockBuilder
from qchem_rs_tpu_torch.ops.fock_stream import StreamingFockBuilder
from qchem_rs_tpu_torch.utils import interop
from qchem_rs_tpu_torch.utils.system import MolecularSystem

#: the Fock modes of ``HartreeFockConfig.fock_mode``
FOCK_MODES = ("incore", "pair", "direct")


@dataclasses.dataclass
class RestrictedHartreeFockOutput:
    """Mirrors RestrictedHartreeFockOutput (rhf.rs:14-30), with extras."""

    orbital_energies: np.ndarray  # ascending
    electronic_energy: float
    nuclear_repulsion: float
    iterations: int
    converged: bool
    # extras beyond the reference output:
    density: np.ndarray
    coefficients: np.ndarray
    timings: dict

    def total_energy(self) -> float:
        return self.electronic_energy + self.nuclear_repulsion


@dataclasses.dataclass
class _ScfResult:
    passes: int
    density: torch.Tensor
    energy: float
    converged: bool
    orbital_energies: torch.Tensor
    coefficients: torch.Tensor


def _sync(device: torch.device) -> None:
    """Wait for the device, so that host clocks time the work."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _rhf_scf(H, X, S, nocc: int, config: HartreeFockConfig, g_fn, D0=None) -> _ScfResult:
    """The SCF fixed-point iteration from ``D0`` (Hückel's guess when
    None), with G = ``g_fn(D)``."""
    n = H.shape[0]
    diis_min, diis_max = config.diis_window(4, 6)
    diis = Diis(diis_max, diis_min, n, H.device)
    metric = config.convergence_metric
    espan = scf.EnergySpan(metric) if metric.startswith("espan") else None
    D = scf.huckel_guess(H, S, X, nocc, scale=2.0) if D0 is None else D0
    energy, rms, converged, passes = 0.0, math.inf, False, 0
    w = torch.zeros(n, dtype=H.dtype, device=H.device)
    C = torch.zeros((n, n), dtype=H.dtype, device=H.device)
    # reference loops 0..=max_iterations (rhf.rs:66): max_iterations+1 passes
    while not converged and passes <= config.max_iterations:
        G = g_fn(D)  # rhf.rs:152-167
        F = H + G
        err = F @ D @ S - S @ D @ F  # rhf.rs:71
        F = diis.apply(err, F)
        if config.level_shift != 0.0:
            C, w = scf.shifted_solve_fock(F, 0.5 * D, X, S, config.level_shift)
        else:
            C, w = scf.solve_fock(F, X)
        D_new = scf.density_from_coeffs(C, nocc, scale=2.0)
        d_change = D_new - D
        D = D + config.mixing_factor * d_change  # rhf.rs:78-82
        new_energy = float(0.5 * torch.sum(D * (2.0 * H + G)))  # rhf.rs:84-85
        new_rms = scf.convergence_value(
            metric, energy=new_energy, prev_energy=energy, err=err, d_change=d_change
        )
        if espan is None:
            converged = scf.converged_flag(metric, new_rms, rms, config.epsilon)
        else:
            converged = espan.converged(new_energy, new_rms, config.epsilon)
        if config.verbose:
            print(f"iteration {passes:<4} - electronic energy {new_energy:1.4f}. "
                  f"density rms {new_rms:1.4e}")
        energy, rms = new_energy, new_rms
        passes += 1
    return _ScfResult(passes, D, energy, converged, w, C)


def _check_config(config: HartreeFockConfig) -> None:
    """Raise for what the port does not run."""
    if config.fock_mode not in FOCK_MODES:
        raise NotImplementedError(f"fock_mode={config.fock_mode!r} is not one of {FOCK_MODES}")
    if config.initial_guess not in ("huckel", "sad"):
        raise NotImplementedError(f"initial_guess={config.initial_guess!r} is not ported")


def check_device(device) -> torch.device:
    """``device`` as a torch.device; raises when it names CUDA and CUDA is
    not available (no fallback to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but CUDA is not available; "
            "pass device='cpu' to run on the CPU"
        )
    return device


def check_occupied(nocc: int, n: int) -> None:
    """Raise when ``nocc`` occupied orbitals do not fit the ``n`` AOs of
    the working basis."""
    if nocc > n:
        raise ValueError(f"{nocc} occupied orbitals do not fit the {n} AOs of the basis")


def _field_terms(system: MolecularSystem, field, device):
    """Core-Hamiltonian and nuclear contributions of a uniform external
    electric field F (a.u.). The electron carries charge -1, so its energy
    in the field is +F.r: H += sum_d F_d <i|r_d|j>; the nuclei add
    -sum_A Z_A F.R_A to the classical energy. Returns (dH, dE_nuclear)."""
    F = torch.as_tensor(field, dtype=torch.float64, device=device)
    dH = torch.einsum("d,dij->ij", F, one_electron.dipole_integrals(system, device))
    de = -float(np.dot(system.charges, np.asarray(system.positions) @ np.asarray(field)))
    return dH, de


def core_hamiltonian(system: MolecularSystem, device, field=(0.0, 0.0, 0.0)):
    """(S, H, X, dE): overlap, core Hamiltonian T + V (plus the field's
    term when ``field`` is not zero), Löwdin X, in the system's working
    basis, and the field's nuclear energy."""
    S = one_electron.overlap(system, device)
    H = one_electron.kinetic(system, device) + one_electron.nuclear(system, device)
    de = 0.0
    if any(field):
        dH, de = _field_terms(system, field, device)
        H = H + dH
    return S, H, scf.lowdin_x(S), de


def two_electron_operator(system: MolecularSystem, config: HartreeFockConfig, device,
                          timings: Optional[dict] = None):
    """(engine, g_fn) of the configured Fock mode on ``device``: g_fn(D) is
    G = J - 1/2 K of a total density D in the working basis, and engine the
    ``TiledEriEngine`` the mode builds with. In core, the operator terms
    are built here (kernel 1) and each G is kernel 2's matvec on them; the
    pair mode builds V2f and W here; the direct mode runs kernel 1 at every
    call. The build's time goes into ``timings["eri_s"]`` (not for direct)."""
    timings = {} if timings is None else timings
    thr = config.screening_threshold
    n = system.n_basis()
    if config.fock_mode == "incore":
        engine = TiledEriEngine(system, thr, device=device)
        t1 = time.perf_counter()
        terms = engine.finish_terms(engine.build())
        _sync(device)
        timings["eri_s"] = time.perf_counter() - t1

        def g_fn(D):
            return fock_matvec.matvec(terms, D.reshape(-1)).reshape(n, n)

        return engine, g_fn
    if config.fock_mode == "pair":
        builder = PairSpaceFockBuilder(system, thr, device=device)
        t1 = time.perf_counter()
        builder.prepare()
        _sync(device)
        timings["eri_s"] = time.perf_counter() - t1
    else:
        builder = StreamingFockBuilder(system, thr, device=device)

    def g_fn(D):
        J, K = builder.jk(D)
        return J - 0.5 * K

    return builder.engine, g_fn


def restricted_hartree_fock(
    system: MolecularSystem,
    config: Optional[HartreeFockConfig] = None,
    *,
    density_guess: Optional[np.ndarray] = None,
    device="cuda",
) -> RestrictedHartreeFockOutput:
    """Run RHF on ``device`` (reference entry point rhf.rs:32-35).

    The default is the card: on a CUDA device the ERI tiles go through
    kernel 1, and kernel 2 takes the in-core operator's matvec or the pair
    mode's Coulomb product. A run on the CPU (both kernels' plain twins)
    must ask for it with ``device="cpu"``; asking for CUDA where it is not
    available raises, with no fallback. ``density_guess`` (numpy
    (nao, nao)) starts the SCF in place of the configured guess.
    """
    config = config or HartreeFockConfig()
    _check_config(config)
    n_electrons = system.n_electrons(config.charge)
    if config.spin_multiplicity not in (0, 1):
        raise ValueError("RHF requires a closed shell (spin multiplicity 1)")
    if n_electrons % 2 != 0 and config.spin_multiplicity == 1:
        raise ValueError(f"RHF needs an even electron count, got {n_electrons}")
    nocc = n_electrons // 2
    device = check_device(device)
    n = system.n_basis()  # the working basis (spherical for a spherical system)
    check_occupied(nocc, n)

    timings: dict = {}
    if density_guess is None and config.initial_guess == "sad":
        from qchem_rs_tpu_torch.models.sad import sad_guess

        t_g = time.perf_counter()
        density_guess = sad_guess(system, charge=config.charge)
        timings["guess_s"] = time.perf_counter() - t_g
    D0 = None if density_guess is None else interop.density_guess(density_guess, n, 1, device)
    t0 = time.perf_counter()
    if config.fock_mode == "incore":
        t1 = time.perf_counter()
        S, H, X, e_field = core_hamiltonian(system, device, config.electric_field)
        _sync(device)
        timings["one_electron_s"] = time.perf_counter() - t1
    else:
        S, H, X, e_field = core_hamiltonian(system, device, config.electric_field)
    _, g_fn = two_electron_operator(system, config, device, timings)
    t1 = time.perf_counter()
    st = _rhf_scf(H, X, S, nocc, config, g_fn, D0)
    _sync(device)
    timings["scf_s"] = time.perf_counter() - t1
    timings["total_s"] = time.perf_counter() - t0
    return RestrictedHartreeFockOutput(
        orbital_energies=st.orbital_energies.cpu().numpy(),
        electronic_energy=st.energy,
        nuclear_repulsion=system.nuclear_repulsion() + e_field,
        iterations=st.passes - 1,  # reference reports the 0-based pass index
        converged=st.converged,
        density=st.density.cpu().numpy(),
        coefficients=st.coefficients.cpu().numpy(),
        timings=timings,
    )
