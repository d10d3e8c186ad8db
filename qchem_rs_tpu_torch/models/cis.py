"""CIS and TDHF (RPA) excitation energies on converged RHF orbitals, and
spin-orbital UCIS on UHF ones (port of ``qchem_rs_tpu/models/cis.py``).

Closed-shell spin-adapted forms (real orbitals):

    A[ia,jb] = d_ij d_ab (e_a - e_i) + 2 (ia|jb) - (ij|ab)   (singlet)
             = d_ij d_ab (e_a - e_i)            - (ij|ab)   (triplet)
    B[ia,jb] =                        2 (ia|jb) - (ib|ja)   (singlet)
             =                                  - (ib|ja)   (triplet)

CIS diagonalizes A; TDHF solves the RPA problem by Casida's reduction
(eigenvalues of S (A + B) S with S = (A - B)^(1/2); a non-positive-definite
A - B raises: the reference is unstable). Oscillator strengths in the
length gauge, f = (2/3) omega |sqrt(2) d_ov . (X + Y)|^2; triplets are
spin-forbidden (f = 0).

The MO blocks come from the in-core n^4 tensor (kernel 1) or, in pair
mode, from the pair-space V2f as U_L^T V2f U_R with no n^4 tensor. The
Davidson solver (``_davidson_sym_lowest``; "auto" past no*nv = 4096) never
assembles the (no*nv)^2 matrix: in pair mode the Coulomb term of each
sigma vector streams through V2f (``_cis_matvec_pair``). Its basis and
sigma vectors stay on ``device``; the projected matrix is diagonalized on
the host. Every product is a plain ``torch`` product on ``device``, as
the JAX package computes them outside any Pallas kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from qchem_rs_tpu_torch.config import HartreeFockConfig
from qchem_rs_tpu_torch.models import scf
from qchem_rs_tpu_torch.models.cc import _incore_e4, _pair_contract
from qchem_rs_tpu_torch.models.fci import _transform_full
from qchem_rs_tpu_torch.models.mp2 import _pair_transform_matrix, _pair_v2f, _transform_ovov
from qchem_rs_tpu_torch.models.rhf import check_device, restricted_hartree_fock
from qchem_rs_tpu_torch.models.uhf import unrestricted_hartree_fock
from qchem_rs_tpu_torch.ops import one_electron
from qchem_rs_tpu_torch.utils.system import MolecularSystem

HARTREE_TO_EV = 27.211386245988


@dataclasses.dataclass
class CisOutput:
    scf_total_energy: float
    excitation_energies: np.ndarray  # (nstates,) Hartree, ascending
    oscillator_strengths: np.ndarray  # (nstates,) length gauge; 0 for triplet
    iterations: int  # SCF iterations of the underlying ground state
    method: str  # "cis" | "tdhf" | "ucis"
    triplet: bool

    def excitation_energies_ev(self) -> np.ndarray:
        return self.excitation_energies * HARTREE_TO_EV


def _transform_oovv(e4: torch.Tensor, Co: torch.Tensor, Cv: torch.Tensor) -> torch.Tensor:
    """(pq|rs) -> (ij|ab): four quarter-transforms, one buffer at a time."""
    return _transform_full(e4, Co, Co, Cv, Cv)


def _cis_blocks_pair(builder, V2f, Co, Cv):
    """(ia|jb) and (ij|ab) against the mirrored pair-space V2f: two matrix
    products per block, no n^4 tensor."""
    no, nv = Co.shape[1], Cv.shape[1]
    U_ov = _pair_transform_matrix(builder, Co, Cv)
    U_oo = _pair_transform_matrix(builder, Co, Co)
    U_vv = _pair_transform_matrix(builder, Cv, Cv)
    ovov = _pair_contract(V2f, U_ov, U_ov).reshape(no, nv, no, nv)
    oovv = _pair_contract(V2f, U_oo, U_vv).reshape(no, no, nv, nv)
    return ovov, oovv


def _assemble_AB(ovov, oovv, eps_o, eps_v, singlet: bool):
    """Dense A and B over the compound (ia) index, spin-adapted."""
    no, nv = ovov.shape[0], ovov.shape[1]
    n = no * nv
    diag = (eps_v[None, :] - eps_o[:, None]).reshape(n)
    K = 2.0 * ovov if singlet else torch.zeros_like(ovov)
    A = (K - oovv.permute(0, 2, 1, 3)).reshape(n, n) + torch.diag(diag)
    B = (K - ovov.permute(0, 3, 2, 1)).reshape(n, n)
    return A, B


def _cis_matvec_dense(ovov, oovv, diag2, singlet: bool):
    """Batched CIS sigma vectors from resident MO blocks (in-core tier)."""
    no, nv = oovv.shape[0], oovv.shape[2]

    def mv(X):  # (m, no*nv) -> (m, no*nv)
        Xr = X.reshape(-1, no, nv)
        y = Xr * diag2[None]
        if singlet:
            y = y + 2.0 * torch.einsum("iajb,njb->nia", ovov, Xr)
        y = y - torch.einsum("ijab,njb->nia", oovv, Xr)
        return y.reshape(X.shape)

    return mv


def _cis_matvec_pair(builder, V2f, Co, Cv, oovv, diag2, singlet: bool):
    """Batched CIS sigma vectors in the pair-space envelope: the Coulomb
    term streams through V2f as J(X_sym) — J annihilates the antisymmetric
    part exactly, so only the symmetrized transition density rides the
    unordered-pair product — and only the (no^2, nv^2) oovv block is ever
    materialized (no (no*nv)^2 tensor)."""
    pidx, wj, pmap = builder._pidx, builder._wj, builder._pmap
    no, nv = Co.shape[1], Cv.shape[1]
    nao = Co.shape[0]

    def mv(X):
        Xr = X.reshape(-1, no, nv)
        y = Xr * diag2[None]
        if singlet:
            Xao = torch.matmul(torch.matmul(Co, Xr), Cv.T)  # [n, p, q]
            Xs = 0.5 * (Xao + Xao.transpose(1, 2))
            dJ = Xs.reshape(Xs.shape[0], nao * nao)[:, pidx] * wj
            Jp = dJ @ V2f  # V2f symmetric
            Jao = Jp[:, pmap].reshape(-1, nao, nao)
            y = y + 2.0 * torch.matmul(torch.matmul(Co.T, Jao), Cv)
        y = y - torch.einsum("ijab,njb->nia", oovv, Xr)
        return y.reshape(X.shape)

    return mv


def _tdhf_solve(A, B):
    """Casida reduction: eigvals of S (A+B) S with S = (A-B)^(1/2).

    Returns (omega^2 ascending, X+Y columns scaled for X^T X - Y^T Y = 1,
    min eigenvalue of A - B for the caller's stability check)."""
    wm, Um = torch.linalg.eigh(A - B)
    S = (Um * torch.sqrt(torch.clamp(wm, min=0.0))) @ Um.T
    w2, Z = torch.linalg.eigh(S @ (A + B) @ S)
    omega = torch.sqrt(torch.clamp(w2, min=0.0))
    xpy = (S @ Z) / torch.sqrt(torch.clamp(omega, min=1e-30))
    return w2, xpy, torch.min(wm)


def _preconditioned(R: torch.Tensor, w: np.ndarray, diag: torch.Tensor, rn: np.ndarray,
                    tol: float) -> list:
    """The Davidson correction vectors R_j / (w_j - diag) of the roots not
    yet converged, the denominator held away from zero."""
    new = []
    for j in range(w.shape[0]):
        if rn[j] < tol:
            continue
        d = w[j] - diag
        d = torch.where(torch.abs(d) < 1e-8, torch.copysign(torch.full_like(d, 1e-8), d + 1e-300), d)
        new.append(R[:, j] / d)
    return new


def _orthonormal_columns(B: torch.Tensor, V: torch.Tensor) -> list:
    """The columns of B made orthogonal to V (two passes) and to each
    other, numerically dependent ones dropped."""
    for _ in range(2):
        if V.shape[1]:
            B = B - V @ (V.T @ B)
    keep = []
    for j in range(B.shape[1]):
        col = B[:, j]
        for kept in keep:
            col = col - kept * (kept @ col)
        nrm = float(torch.linalg.norm(col))
        if nrm > 1e-10:
            keep.append(col / nrm)
    return keep


def _host_qr(X: torch.Tensor) -> torch.Tensor:
    """Q of X's QR, factored on the host."""
    Q, _ = np.linalg.qr(X.cpu().numpy())
    return torch.as_tensor(Q, device=X.device)


def _start_block(diag: torch.Tensor, nb: int) -> torch.Tensor:
    """The nb unit vectors on the lowest diagonal entries (host argsort)."""
    dim = diag.numel()
    d = diag.cpu().numpy()
    order = np.argsort(np.where(np.isfinite(d), d, np.inf))[:nb]
    V = torch.zeros((dim, nb), dtype=diag.dtype, device=diag.device)
    V[torch.as_tensor(order, device=diag.device), torch.arange(nb, device=diag.device)] = 1.0
    return V


def _davidson_sym_lowest(
    matvec,
    diag: torch.Tensor,
    k: int,
    *,
    tol: float = 1e-8,
    max_iter: int = 100,
    max_subspace: int = 0,
):
    """Lowest-k eigenpairs of an implicit symmetric matrix by block Davidson.

    ``matvec`` maps a (m, dim) batch of row vectors to (m, dim) on
    ``diag``'s device. The basis V and its images A V stay there; the
    projected matrix V^T A V is diagonalized on the host. Each iteration
    orthonormalizes only the new preconditioned residuals against V and
    extends A V by one batched matvec; restarts collapse to the current
    Ritz vectors. Returns (w numpy, X (dim, k) tensor, converged)."""
    dim = diag.numel()
    k = min(k, dim)
    max_subspace = max_subspace or max(6 * k, 48)
    nb = min(dim, max(2 * k, k + 4))
    V = diag.new_empty((dim, 0))
    AV = diag.new_empty((dim, 0))

    def _extend(B):
        nonlocal V, AV
        AB = matvec(B.T.contiguous()).T
        V = torch.cat([V, B], dim=1)
        AV = torch.cat([AV, AB], dim=1)

    _extend(_start_block(diag, nb))
    w = X = None
    for _ in range(max_iter):
        T = (V.T @ AV).cpu().numpy()
        T = 0.5 * (T + T.T)
        w_all, S_all = np.linalg.eigh(T)
        w, S = w_all[:k], torch.as_tensor(S_all[:, :k], device=V.device)
        X = V @ S
        R = AV @ S - X * torch.as_tensor(w, device=V.device)
        rn = torch.linalg.norm(R, dim=0).cpu().numpy()
        if np.all(rn < tol):
            return w, X, True
        keep = _orthonormal_columns(torch.stack(_preconditioned(R, w, diag, rn, tol), dim=1), V)
        if not keep:
            return w, X, True  # stagnated at numerical precision
        B = torch.stack(keep, dim=1)
        if V.shape[1] + B.shape[1] > max_subspace:
            # restart from Ritz vectors
            V, AV = diag.new_empty((dim, 0)), diag.new_empty((dim, 0))
            _extend(_host_qr(X))
        _extend(B)
    return w, X, False


def _mo_transition_dipoles(system, C, nocc):
    """d_ov[3, no, nv] = <i| r |a> in the SCF working AO basis."""
    d_ao = one_electron.dipole_integrals(system, C.device)
    Co, Cv = C[:, :nocc], C[:, nocc:]
    return torch.einsum("pi,dpq,qa->dia", Co, d_ao, Cv)


def _ucis_blocks(system, config, C, nocc, builder=None):
    """Spin-resolved MO integral blocks for UCIS: per-spin (ia|jb) and
    (ij|ab), plus the opposite-spin Coulomb coupling (i_a a_a | j_b b_b).
    Pair mode contracts against the mirrored V2f (of ``builder`` when it
    has one prepared); otherwise the in-core tensor."""
    Co = [C[s][:, : nocc[s]] for s in range(2)]
    Cv = [C[s][:, nocc[s] :] for s in range(2)]
    sh = [(Co[s].shape[1], Cv[s].shape[1]) for s in range(2)]
    if config.fock_mode == "pair":
        V2f, builder = _pair_v2f(system, config, C.device, builder)
        U_ov = [_pair_transform_matrix(builder, Co[s], Cv[s]) for s in range(2)]
        U_oo = [_pair_transform_matrix(builder, Co[s], Co[s]) for s in range(2)]
        U_vv = [_pair_transform_matrix(builder, Cv[s], Cv[s]) for s in range(2)]
        ovov = [_pair_contract(V2f, U_ov[s], U_ov[s]).reshape(*sh[s], *sh[s]) for s in range(2)]
        oovv = [_pair_contract(V2f, U_oo[s], U_vv[s]).reshape(sh[s][0], sh[s][0], sh[s][1],
                                                              sh[s][1]) for s in range(2)]
        ovov_ab = _pair_contract(V2f, U_ov[0], U_ov[1]).reshape(*sh[0], *sh[1])
        return ovov, oovv, ovov_ab
    e4 = _incore_e4(system, config, C.device)
    ovov = [_transform_ovov(e4, Co[s], Cv[s]) for s in range(2)]
    oovv = [_transform_oovv(e4, Co[s], Cv[s]) for s in range(2)]
    ovov_ab = _transform_ovov(e4, Co[0], Cv[0], Co[1], Cv[1])
    return ovov, oovv, ovov_ab


def _ucis_matvec(ovov, oovv, ovov_ab, diag_a, diag_b, dims):
    """Batched UCIS sigma vectors over the concatenated [alpha | beta]
    single-excitation vector (Davidson path; Ms-conserving blocks)."""
    (no_a, nv_a), (no_b, nv_b) = dims
    na_dim = no_a * nv_a

    def mv(X):  # (m, na_dim + nb_dim)
        Xa = X[:, :na_dim].reshape(-1, no_a, nv_a)
        Xb = X[:, na_dim:].reshape(-1, no_b, nv_b)
        ya = (Xa * diag_a[None] + torch.einsum("iajb,njb->nia", ovov[0], Xa)
              - torch.einsum("ijab,njb->nia", oovv[0], Xa)
              + torch.einsum("iajb,njb->nia", ovov_ab, Xb))
        yb = (Xb * diag_b[None] + torch.einsum("iajb,njb->nia", ovov[1], Xb)
              - torch.einsum("ijab,njb->nia", oovv[1], Xb)
              + torch.einsum("iajb,nia->njb", ovov_ab, Xa))
        return torch.cat([ya.reshape(X.shape[0], -1), yb.reshape(X.shape[0], -1)], dim=1)

    return mv


def _check_solver(solver: str) -> None:
    if solver not in ("auto", "dense", "davidson"):
        raise ValueError(f"unknown solver={solver!r}")


def ucis(
    system: MolecularSystem,
    config: Optional[HartreeFockConfig] = None,
    *,
    nstates: int = 5,
    solver: str = "auto",
    output=None,
    builder=None,
    device="cuda",
) -> CisOutput:
    """Spin-orbital CIS on a UHF reference (open shells; Ms-conserving
    alpha->alpha / beta->beta excitations).

        A[ia,jb]^{ss}  = d d (e_a - e_i) + (ia|jb) - (ij|ab)
        A[ia,jb]^{ab}  =                   (ia|jb)            (Coulomb only)

    On a closed-shell reference the spectrum is the union of the singlet
    and triplet restricted CIS spectra. ``solver`` mirrors cis():
    "davidson" iterates the lowest states with implicit sigma vectors
    (auto past a total single-excitation dimension of 4096)."""
    config = config or HartreeFockConfig(epsilon=1e-10, max_iterations=300)
    device = check_device(device)
    out = output or unrestricted_hartree_fock(system, config, device=device)
    if not out.converged:
        raise RuntimeError("SCF not converged; CIS needs a converged reference")
    nocc = scf.electron_counts(system.n_electrons(config.charge), config.spin_multiplicity)
    C = torch.as_tensor(out.coefficients, dtype=torch.float64, device=device)
    Cw = C  # SCF working basis (for transition dipoles)
    if system.spherical and config.fock_mode == "pair":
        C = torch.einsum("pq,sqm->spm", torch.as_tensor(system.sph_T, dtype=C.dtype,
                                                         device=device), C)
    eps = [torch.as_tensor(out.orbital_energies_alpha, dtype=torch.float64, device=device),
           torch.as_tensor(out.orbital_energies_beta, dtype=torch.float64, device=device)]
    n = C.shape[2]
    dims = [(nocc[s], n - nocc[s]) for s in range(2)]
    if any(no == 0 or nv == 0 for no, nv in dims):
        raise ValueError("UCIS needs occupied and virtual orbitals in both spins")
    _check_solver(solver)
    total_dim = sum(no * nv for no, nv in dims)
    use_dav = solver == "davidson" or (solver == "auto" and total_dim > 4096)

    ovov, oovv, ovov_ab = _ucis_blocks(system, config, C, nocc, builder)
    diag2 = [eps[s][nocc[s] :][None, :] - eps[s][: nocc[s]][:, None] for s in range(2)]
    if use_dav:
        matvec = _ucis_matvec(ovov, oovv, ovov_ab, diag2[0], diag2[1], dims)
        diag_flat = torch.cat([diag2[0].reshape(-1), diag2[1].reshape(-1)])
        omega, X, ok = _davidson_sym_lowest(matvec, diag_flat, nstates, tol=1e-7)
        if not ok:
            raise RuntimeError("Davidson iteration did not converge")
    else:
        blocks = []
        for s in range(2):
            no, nv = dims[s]
            blocks.append((ovov[s] - oovv[s].permute(0, 2, 1, 3)).reshape(no * nv, no * nv)
                          + torch.diag(diag2[s].reshape(-1)))
        Aab = ovov_ab.reshape(dims[0][0] * dims[0][1], dims[1][0] * dims[1][1])
        A = torch.cat([torch.cat([blocks[0], Aab], dim=1), torch.cat([Aab.T, blocks[1]], dim=1)])
        omega_t, X = torch.linalg.eigh(A)
        omega = omega_t.cpu().numpy()

    d_ao = one_electron.dipole_integrals(system, device)
    d_ov = torch.cat([torch.einsum("pi,dpq,qa->dia", Cw[s][:, : nocc[s]], d_ao,
                                   Cw[s][:, nocc[s] :]).reshape(3, -1) for s in range(2)], dim=1)
    k = min(nstates, omega.shape[0])
    t = (d_ov @ X).cpu().numpy()  # spin orbitals: no sqrt(2)
    f = (2.0 / 3.0) * omega * (t**2).sum(axis=0)
    return CisOutput(scf_total_energy=out.total_energy(), excitation_energies=omega[:k],
                     oscillator_strengths=f[:k], iterations=out.iterations, method="ucis",
                     triplet=False)


def cis(
    system: MolecularSystem,
    config: Optional[HartreeFockConfig] = None,
    *,
    nstates: int = 5,
    triplet: bool = False,
    tdhf: bool = False,
    solver: str = "auto",
    output=None,
    builder=None,
    device="cuda",
) -> CisOutput:
    """Lowest ``nstates`` CIS (or TDHF) excitations on a converged RHF.

    ``config.fock_mode == "pair"`` routes the MO-integral blocks through
    the pair-space V2f (of ``builder`` when it has one prepared, else built
    and mirrored once; no n^4 AO tensor); any other mode uses the in-core
    transform.

    ``solver``: "dense" diagonalizes the assembled A; "davidson" iterates
    the lowest states with implicit sigma vectors (never assembles the
    (no*nv)^2 matrix); "auto" picks davidson past no*nv = 4096 (CIS only —
    TDHF stays dense via the Casida reduction).
    """
    config = config or HartreeFockConfig(epsilon=1e-10, max_iterations=200)
    device = check_device(device)
    out = output or restricted_hartree_fock(system, config, device=device)
    if not out.converged:
        raise RuntimeError("SCF not converged; CIS needs a converged reference")
    nocc = system.n_electrons(config.charge) // 2
    C = torch.as_tensor(out.coefficients, dtype=torch.float64, device=device)
    eps = torch.as_tensor(out.orbital_energies, dtype=torch.float64, device=device)
    nv = C.shape[1] - nocc
    if nocc == 0 or nv == 0:
        raise ValueError("CIS needs at least one occupied and one virtual orbital")
    _check_solver(solver)
    if tdhf and solver == "davidson":
        raise ValueError("solver='davidson' supports CIS only; TDHF is dense")
    use_dav = (not tdhf) and (solver == "davidson" or (solver == "auto" and nocc * nv > 4096))

    diag2 = eps[nocc:][None, :] - eps[:nocc][:, None]
    matvec = None
    if config.fock_mode == "pair":
        Cx = C
        if system.spherical:
            # V2f is Cartesian: lift the MO coefficients (mp2.py pattern)
            Cx = torch.as_tensor(system.sph_T, dtype=C.dtype, device=device) @ C
        V2f, builder = _pair_v2f(system, config, device, builder)
        Co, Cv = Cx[:, :nocc], Cx[:, nocc:]
        if use_dav:
            U_oo = _pair_transform_matrix(builder, Co, Co)
            U_vv = _pair_transform_matrix(builder, Cv, Cv)
            oovv = _pair_contract(V2f, U_oo, U_vv).reshape(nocc, nocc, nv, nv)
            del U_oo, U_vv
            matvec = _cis_matvec_pair(builder, V2f, Co, Cv, oovv, diag2, not triplet)
        else:
            ovov, oovv = _cis_blocks_pair(builder, V2f, Co, Cv)
    else:
        e4 = _incore_e4(system, config, device)
        ovov = _transform_ovov(e4, C[:, :nocc], C[:, nocc:])
        oovv = _transform_oovv(e4, C[:, :nocc], C[:, nocc:])
        del e4
        if use_dav:
            matvec = _cis_matvec_dense(ovov, oovv, diag2, not triplet)

    # transition dipoles live in the SCF working basis (not the Cartesian
    # lift): d_ov from the original C
    d_ov = _mo_transition_dipoles(system, C, nocc).reshape(3, -1)

    if use_dav:
        omega, X, ok = _davidson_sym_lowest(matvec, diag2.reshape(-1), nstates, tol=1e-7)
        if not ok:
            raise RuntimeError("Davidson iteration did not converge")
        t = (d_ov @ X).cpu().numpy() * np.sqrt(2.0)
        f = (2.0 / 3.0) * omega * (t**2).sum(axis=0)
        if triplet:
            f = np.zeros_like(f)
        k = min(nstates, omega.shape[0])
        return CisOutput(scf_total_energy=out.total_energy(), excitation_energies=omega[:k],
                         oscillator_strengths=f[:k], iterations=out.iterations, method="cis",
                         triplet=triplet)

    A, B = _assemble_AB(ovov, oovv, eps[:nocc], eps[nocc:], not triplet)
    if tdhf:
        w2, xpy, wm_min = _tdhf_solve(A, B)
        if float(wm_min) <= 0.0:
            raise RuntimeError(
                "A - B is not positive definite: the RHF reference is "
                f"unstable (min eig {float(wm_min):.3e}); TDHF is undefined"
            )
        omega = np.sqrt(np.maximum(w2.cpu().numpy(), 0.0))
        amp = xpy  # (X + Y), normalized X^T X - Y^T Y = 1
    else:
        omega_t, amp = torch.linalg.eigh(A)  # Y = 0
        omega = omega_t.cpu().numpy()

    k = min(nstates, omega.shape[0])
    # spin-adapted transition dipole: sqrt(2) d . (X + Y); triplet forbidden
    t = (d_ov @ amp).cpu().numpy() * np.sqrt(2.0)
    f = (2.0 / 3.0) * omega * (t**2).sum(axis=0)
    if triplet:
        f = np.zeros_like(f)
    return CisOutput(scf_total_energy=out.total_energy(), excitation_energies=omega[:k],
                     oscillator_strengths=f[:k], iterations=out.iterations,
                     method="tdhf" if tdhf else "cis", triplet=triplet)
