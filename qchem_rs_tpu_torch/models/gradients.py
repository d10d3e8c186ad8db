"""Analytic nuclear gradients of RHF and UHF (port of
``qchem_rs_tpu/models/gradients.py``).

The functional is the JAX package's: at frozen, re-orthonormalized
orbitals

    C(x) = C0 (1.5 I - 0.5 C0^T S(x) C0)      (= C0 M(x)^{-1/2} to first order)
    E(x) = E_HF[D(C(x)), x] + E_nuc(x)

equals the SCF energy at the converged geometry x0, and its first
derivative there is the analytic SCF gradient: the M^{-1/2} factor gives
the energy-weighted-density (Pulay) term, and orbital relaxation drops by
stationarity. The first-order series is used, not an eigendecomposition:
at M = I every eigenvalue is the same and ``eigh``'s backward divides by
their gaps.

The port computes the same first derivative in two parts:

- the density response and the one-electron and nuclear terms, by
  autograd through the surrogate Tr[D(x) (H(x) + G0)] + E_nuc(x), where
  G0 = G(D0) is the converged two-electron Fock term. Its derivative at x0
  is Tr[dD (H + G0)] + Tr[D0 dH] + dE_nuc, which is the functional's but
  for the derivative integrals. G0 comes from the configured Fock mode's
  own build (``rhf.two_electron_operator``, ``uhf.jk_operator``): kernel 2
  on the in-core operator or on V2f, or one pass of kernel 1 in direct
  mode;
- the derivative integrals contracted with the frozen two-particle
  density, segment by segment in pair space
  (``gradients_pair.PairGradientProgram``).

One implementation serves the in-core, pair and direct modes and UHF; they
differ only in the build that gives G0 (and in the SCF before it).
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from qchem_rs_tpu_torch.config import HartreeFockConfig
from qchem_rs_tpu_torch.models import scf
from qchem_rs_tpu_torch.models.gradients_pair import PairGradientProgram, deterministic
from qchem_rs_tpu_torch.models.rhf import (
    _sync,
    check_device,
    restricted_hartree_fock,
    two_electron_operator,
)
from qchem_rs_tpu_torch.models.uhf import jk_operator, unrestricted_hartree_fock
from qchem_rs_tpu_torch.ops import one_electron
from qchem_rs_tpu_torch.utils.system import MolecularSystem, nuclear_repulsion


def _inv_sqrt_sym(M: torch.Tensor) -> torch.Tensor:
    """M^{-1/2} for M near the identity by the series truncated at first
    order, I - (M - I)/2: exact in value at M = I and in its first
    derivative there, which is all a nuclear gradient needs."""
    n = M.shape[0]
    return 1.5 * torch.eye(n, dtype=M.dtype, device=M.device) - 0.5 * M


def _check_field(config: HartreeFockConfig) -> None:
    if any(config.electric_field):
        # the functional does not carry the field's position-dependent
        # dipole terms; silently wrong forces are worse than an error
        raise NotImplementedError(
            "analytic gradients under an external electric field are not "
            "implemented; run with electric_field=(0,0,0)"
        )


def _one_electron_gradient(system, C0, occ, scale, G0) -> torch.Tensor:
    """d/dx of sum_s Tr[D_s(x) (H(x) + G0_s)] + E_nuc(x) at x0, with
    D_s(x) = scale C_s(x) diag(occ_s) C_s(x)^T (working basis)."""
    dev = C0.device
    pos = torch.as_tensor(system.positions, dtype=torch.float64, device=dev).requires_grad_()
    S = one_electron.overlap(system, dev, pos)
    H = one_electron.kinetic(system, dev, pos) + one_electron.nuclear(system, dev, pos)
    e = nuclear_repulsion(torch.as_tensor(system.charges, dtype=torch.float64, device=dev), pos)
    for C0s, occs, G0s in zip(C0, occ, G0):
        C = C0s @ _inv_sqrt_sym(C0s.T @ S @ C0s)
        D = scale * (C * occs[None, :]) @ C.T
        e = e + (D * (H + G0s)).sum()
    (g,) = torch.autograd.grad(e, pos)
    return g


def frozen_orbital_gradient(system: MolecularSystem, config: HartreeFockConfig, open_shell: bool,
                            output, device, timings: Optional[dict] = None) -> np.ndarray:
    """d E / d positions (natom, 3) of the converged RHF (UHF when
    ``open_shell``) ``output``, or of a new SCF run when it is None, on
    ``device``. ``timings`` (a dict) receives the time of each part:
    scf_s, g0_s (the build of G0 and its product), one_electron_s,
    two_electron_s (the derivative integrals), the segment count and the
    peak device memory of the derivative integrals (CUDA)."""
    _check_field(config)
    device = check_device(device)
    timings = {} if timings is None else timings
    t0 = time.perf_counter()
    if output is None:
        run = unrestricted_hartree_fock if open_shell else restricted_hartree_fock
        output = run(system, config, device=device)
    timings["scf_s"] = time.perf_counter() - t0
    if not output.converged:
        raise RuntimeError("SCF not converged; gradient would be meaningless")
    n = system.n_basis()
    ar = torch.arange(n, device=device)
    C0 = torch.as_tensor(output.coefficients, dtype=torch.float64, device=device)
    t1 = time.perf_counter()
    if open_shell:
        nocc = scf.electron_counts(system.n_electrons(config.charge), config.spin_multiplicity)
        occ = torch.stack([ar < k for k in nocc]).to(torch.float64)
        D = torch.einsum("sik,sk,sjk->sij", C0, occ, C0)
        engine, jk_fn = jk_operator(system, config, device)
        J, K = jk_fn(D)
        G0 = J[None] - K
        del jk_fn
        scale, Ds, weights = 1.0, D, (1.0, 1.0)
    else:
        nocc = system.n_electrons(config.charge) // 2
        C0 = C0[None]
        occ = (ar < nocc).to(torch.float64)[None]
        D = 2.0 * (C0[0] * occ[0][None, :]) @ C0[0].T
        engine, g_fn = two_electron_operator(system, config, device)
        G0 = g_fn(D)[None]
        del g_fn
        scale, Ds, weights = 2.0, 0.5 * D[None], (2.0,)
    _sync(device)
    timings["g0_s"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    with torch.enable_grad(), deterministic():
        g = _one_electron_gradient(system, C0, occ, scale, G0)
    _sync(device)
    timings["one_electron_s"] = time.perf_counter() - t1
    if system.spherical:
        T = torch.as_tensor(system.sph_T, dtype=torch.float64, device=device)
        Ds = T @ Ds @ T.T  # the pair space is Cartesian
    t1 = time.perf_counter()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    prog = PairGradientProgram(engine)
    g = g + prog(Ds, weights)
    _sync(device)
    timings["two_electron_s"] = time.perf_counter() - t1
    timings["segments"] = len(prog.segments)
    if device.type == "cuda":
        timings["two_electron_peak_bytes"] = torch.cuda.max_memory_allocated(device)
    return g.cpu().numpy()


def rhf_gradient(
    system: MolecularSystem,
    config: Optional[HartreeFockConfig] = None,
    *,
    output=None,
    device="cuda",
    timings: Optional[dict] = None,
) -> np.ndarray:
    """Analytic d E_RHF / d positions, shape (natom, 3), Hartree/Bohr, on
    ``device`` (the card by default; ``device="cpu"`` runs the kernels'
    twins).

    Runs (or takes) a converged RHF, then differentiates the frozen-
    coefficient functional. The SCF must be converged tightly (the error
    is first order in its residual; epsilon <= 1e-8 recommended).
    ``fock_mode="pair"`` routes to ``rhf_gradient_pair``, whose envelope has
    no n^4 tensor."""
    config = config or HartreeFockConfig(epsilon=1e-10, max_iterations=200)
    if config.fock_mode == "pair":
        from qchem_rs_tpu_torch.models.gradients_pair import rhf_gradient_pair

        return rhf_gradient_pair(system, config, output=output, device=device, timings=timings)
    return frozen_orbital_gradient(system, config, False, output, device, timings)


def rhf_energy_and_gradient(system: MolecularSystem, config: Optional[HartreeFockConfig] = None,
                            *, device="cuda"):
    """(total energy, gradient) of one RHF run."""
    config = config or HartreeFockConfig(epsilon=1e-10, max_iterations=200)
    out = restricted_hartree_fock(system, config, device=device)
    return out.total_energy(), rhf_gradient(system, config, output=out, device=device)


def is_open_shell(system: MolecularSystem, config: HartreeFockConfig) -> bool:
    """UHF is required: a multiplicity other than singlet, or an odd
    electron count (routed to a correct UHF, not the reference's silent
    n/2-n/2 split, uhf.rs:43-45)."""
    return config.spin_multiplicity not in (0, 1) or (
        system.n_electrons(config.charge) % 2 == 1
    )


def scf_and_gradient(system: MolecularSystem, config: HartreeFockConfig, *, density_guess=None,
                     device="cuda"):
    """(SCF output, gradient) with the method chosen by shell parity: the
    shared step of ``optimize_geometry`` and ``hessian_fd``, so both serve
    open shells through ``uhf_gradient``."""
    open_shell = is_open_shell(system, config)
    run = unrestricted_hartree_fock if open_shell else restricted_hartree_fock
    out = run(system, config, density_guess=density_guess, device=device)
    if not out.converged:
        raise RuntimeError("SCF did not converge")
    grad = uhf_gradient if open_shell else rhf_gradient
    return out, grad(system, config, output=out, device=device)


def uhf_gradient(
    system: MolecularSystem,
    config: Optional[HartreeFockConfig] = None,
    *,
    output=None,
    device="cuda",
    timings: Optional[dict] = None,
) -> np.ndarray:
    """Analytic d E_UHF / d positions (the same frozen-coefficient
    functional per spin: E = sum_s 1/2 Tr[D^s (2H + G^s)],
    G^s = J(D_total) - K(D^s)), on ``device``."""
    config = config or HartreeFockConfig(epsilon=1e-10, max_iterations=300)
    if config.fock_mode == "pair":
        from qchem_rs_tpu_torch.models.gradients_pair import uhf_gradient_pair

        return uhf_gradient_pair(system, config, output=output, device=device, timings=timings)
    return frozen_orbital_gradient(system, config, True, output, device, timings)
