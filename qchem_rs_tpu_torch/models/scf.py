"""Shared SCF machinery: Löwdin orthogonalization, extended-Hückel guess,
density builds and the convergence tests (port of
``qchem_rs_tpu/models/scf.py``).

Reference algorithms mirrored (qchem-rs core/src/hf/rhf.rs):
- symmetric (Löwdin S^-1/2) transform: rhf.rs:124-131
- extended-Hückel guess (Wolfsberg-Helmholtz k = 1.75): rhf.rs:133-150
- density update D_ij = occ_scale * sum_k^occ C_ik C_jk: rhf.rs:169-181
- diagonal-only density RMS convergence metric: rhf.rs:87-88 (quirk kept as
  the default; full-matrix RMS available via config)
"""

from __future__ import annotations

import math

import torch

WOLFSBERG_HELMHOLTZ = 1.75


def lowdin_x(S: torch.Tensor) -> torch.Tensor:
    """Symmetric orthogonalization X = U s^-1/2 U^T."""
    w, U = torch.linalg.eigh(S)
    return (U / torch.sqrt(w)[None, :]) @ U.T


def density_from_coeffs(C: torch.Tensor, nocc: int, scale: float) -> torch.Tensor:
    """D = scale * C_occ C_occ^T (scale 2 for RHF)."""
    Cocc = C[:, :nocc]
    return scale * (Cocc @ Cocc.T)


def solve_fock(F: torch.Tensor, X: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Eigensolve in the orthogonal basis: returns (C, orbital_energies),
    eigenvalues ascending."""
    Fp = X.T @ F @ X
    w, Cp = torch.linalg.eigh(Fp)
    return X @ Cp, w


def huckel_guess(H, S, X, nocc: int, scale: float) -> torch.Tensor:
    """Extended-Hückel initial density (rhf.rs:133-150)."""
    h = torch.diagonal(H)
    H_eht = WOLFSBERG_HELMHOLTZ * S * 0.5 * (h[:, None] + h[None, :])
    C, _ = solve_fock(H_eht, X)
    return density_from_coeffs(C, nocc, scale)


def density_rms(d_change: torch.Tensor, metric: str) -> torch.Tensor:
    """Convergence metric on the density change: "diag_rms" is the
    reference's RMS over the diagonal only, normalized by n_basis;
    "full_rms" the full-matrix RMS."""
    n = d_change.shape[-1]
    if metric == "diag_rms":
        return torch.sqrt(torch.sum(torch.diagonal(d_change) ** 2) / n)
    if metric == "full_rms":
        return torch.sqrt(torch.sum(d_change**2) / (n * n))
    raise ValueError(f"unknown convergence metric {metric!r}")


def composite_guard(metric: str) -> float:
    """diag_rms guard of a "composite[:<guard>]" metric (default 1e-6)."""
    return float(metric.split(":", 1)[1]) if ":" in metric else 1e-6


def convergence_value(metric: str, *, energy: float, prev_energy: float,
                      err: torch.Tensor, d_change: torch.Tensor) -> float:
    """The scalar tested against epsilon: "energy" |dE|; "diis_err"
    max|FDS - SDF|; "composite[:<guard>]" |dE| gated to +inf until the
    diagonal density RMS is below <guard>; otherwise a density RMS. A
    trailing "2" (diag_rms2, full_rms2, diis_err2) names the same value with
    the two-pass stop of ``converged_flag``."""
    if metric == "energy":
        return abs(energy - prev_energy)
    if metric in ("diis_err", "diis_err2"):
        return float(torch.max(torch.abs(err)))
    if metric.startswith("composite"):
        diag = float(density_rms(d_change, "diag_rms"))
        return abs(energy - prev_energy) if diag < composite_guard(metric) else math.inf
    if metric.startswith("espan"):
        raise NotImplementedError("the espan metric is not ported")
    return float(density_rms(d_change, metric.removesuffix("2")))


def converged_flag(metric: str, rms: float, prev_rms: float, epsilon: float) -> bool:
    """Stop on ``rms < epsilon``; the composite metric and the sustained
    "…2" variants also need the previous pass below epsilon."""
    conv = rms < epsilon
    if metric.startswith("composite") or metric.endswith("2"):
        conv = conv and prev_rms < epsilon
    return conv
