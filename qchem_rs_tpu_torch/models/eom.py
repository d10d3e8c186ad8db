"""EOM-CCSD excitation energies and transition properties (port of
``qchem_rs_tpu/models/eom.py``), in two tiers.

The determinant tier (``eom_ccsd``, ``ip_eom_ccsd``, ``ea_eom_ccsd``,
``eom_ccsd_properties``) is exact EOM-CCSD built the determinant way:
the FCI machinery (``models/fci.py``) supplies H as a dense matrix over
(alpha-string x beta-string) determinants, T1 + T2 are applied as
operators with generic fermionic bookkeeping, e^{+-T} are finite
nilpotent series, and P Hbar P is diagonalized over the rank <= 2
determinants. Host numpy, as in the JAX package; the SCF, the ERI build,
the CCSD amplitudes and the MO transform under it run on ``device``.

The matrix-free tier (``eom_ccsd_davidson``,
``eom_ccsd_transition_moments``) uses that R (a pure excitation
operator) commutes with T, so

    <Phi_K| Hbar R |Phi0> = (dG/dt . r)_K + E_cc r_K,

with G(t) the CCSD residual: the sigma vector is one ``torch.func.jvp``
through the amplitude step of ``models/cc.py`` (spinorbital, or the
spatial closed-shell step for singlets), the left sigma vector one
``vjp``, and Davidson (``_davidson_nonsym_lowest``) finds the lowest
roots. Its basis and sigma vectors stay on ``device``; the projected
matrix is diagonalized on the host.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
from torch.func import grad, jvp, vjp

from qchem_rs_tpu_torch.config import HartreeFockConfig
from qchem_rs_tpu_torch.models import scf
from qchem_rs_tpu_torch.models.cc import (_ccsd_rhf_step, _d2, _incore_e4, _mo_phys_blocks,
                                          spatial_amplitudes, spinorbital_amplitudes)
from qchem_rs_tpu_torch.models.cc_lambda import (_mo_blocks, _nuclear_dipole, _residual_fns,
                                                 _solve_lambda)
from qchem_rs_tpu_torch.models.cis import (_host_qr, _orthonormal_columns, _preconditioned,
                                          _start_block)
from qchem_rs_tpu_torch.models.fci import _build_hamiltonian, _strings, _transform_full
from qchem_rs_tpu_torch.models.rhf import check_device, core_hamiltonian, restricted_hartree_fock
from qchem_rs_tpu_torch.ops import one_electron
from qchem_rs_tpu_torch.utils.system import MolecularSystem

HARTREE_TO_EV = 27.211386245988


@dataclasses.dataclass
class EomOutput:
    scf_total_energy: float
    ccsd_total_energy: float
    excitation_energies: np.ndarray  # (nstates,) Hartree, ascending
    dimension: int  # rank<=2 projection dimension
    fci_dimension: int
    cc_iterations: int
    #: max |<singles+doubles| Hbar |Phi0>| — the CCSD amplitude equations
    #: evaluated through the determinant machinery
    amplitude_residual: float
    #: left (vjp) spectrum when solved (eom_ccsd_davidson(left=True))
    left_excitation_energies: Optional[np.ndarray] = None

    def excitation_energies_ev(self) -> np.ndarray:
        return self.excitation_energies * HARTREE_TO_EV


def _annihilate(mask: int, q: int):
    if not (mask >> q) & 1:
        return None
    below = bin(mask & ((1 << q) - 1)).count("1")
    return (1 - 2 * (below & 1), mask ^ (1 << q))


def _create(mask: int, p: int):
    if (mask >> p) & 1:
        return None
    below = bin(mask & ((1 << p) - 1)).count("1")
    return (1 - 2 * (below & 1), mask | (1 << p))


def _t_matrix(t1_so, t2_so, n, na, nb, dets, index):
    """Dense matrix of T = sum t1 a+_A a_I + 1/4 sum t2 a+_A a+_B a_J a_I
    over the determinant basis. Spinorbital index convention of
    ``cc._spinorbital_setup`` ([occ_a, occ_b | virt_a, virt_b]); determinant
    masks put alpha spatial p at bit p, beta at bit n + p."""
    no = na + nb
    nv_a = n - na

    def so_bit(k: int, occupied: bool) -> int:
        """Spinorbital (cc ordering) -> bit position in the det mask."""
        if occupied:
            return k if k < na else n + (k - na)
        v = k - no
        return (na + v) if v < nv_a else n + nb + (v - nv_a)

    dim = len(dets)
    T = np.zeros((dim, dim))
    t1 = np.asarray(t1_so)
    t2 = np.asarray(t2_so)
    singles = [(so_bit(i, True), so_bit(no + a_, False), t1[i, a_])
               for i, a_ in zip(*np.nonzero(np.abs(t1) > 1e-14))]
    I, J, A, B = np.nonzero(np.abs(t2) > 1e-14)
    doubles = [(so_bit(i, True), so_bit(j, True), so_bit(no + a_, False), so_bit(no + b_, False),
                t2[i, j, a_, b_]) for i, j, a_, b_ in zip(I, J, A, B)]
    for col, mask in enumerate(dets):
        for ib, ab, amp in singles:
            r = _annihilate(mask, ib)
            if r is None:
                continue
            s1, m1 = r
            r = _create(m1, ab)
            if r is None:
                continue
            s2, m2 = r
            T[index[m2], col] += s1 * s2 * amp
        # 1/4 sum t2[IJAB] a+_A a+_B a_J a_I
        for ib, jb, ab, bb, amp in doubles:
            r = _annihilate(mask, ib)
            if r is None:
                continue
            s1, m1 = r
            r = _annihilate(m1, jb)
            if r is None:
                continue
            s2, m2 = r
            r = _create(m2, bb)
            if r is None:
                continue
            s3, m3 = r
            r = _create(m3, ab)
            if r is None:
                continue
            s4, m4 = r
            T[index[m4], col] += 0.25 * s1 * s2 * s3 * s4 * amp
    return T


def _expm_nilpotent(T: np.ndarray, max_power: int = 64) -> np.ndarray:
    """exp(T) for a strictly excitation-raising T: the series terminates."""
    X = np.eye(T.shape[0])
    term = np.eye(T.shape[0])
    for k in range(1, max_power + 1):
        term = term @ T / k
        X += term
        if np.max(np.abs(term)) < 1e-16:
            return X
    raise RuntimeError("exp(T) series did not terminate (T not nilpotent?)")


@dataclasses.dataclass
class IpEaOutput:
    ccsd_total_energy: float
    energies: np.ndarray  # (nstates,) Hartree: IPs (positive) or EAs
    kind: str  # "ip" | "ea"
    dimension: int
    koopmans: float  # -eps_HOMO (ip) / -eps_LUMO (ea) for comparison


def _hbar_sector(ctx, na: int, nb: int, return_transforms: bool = False):
    """Similarity-transformed H over the (na, nb)-electron determinant
    sector, using the N-electron reference's orbitals and amplitudes (T
    acts in any sector)."""
    H, dim = _build_hamiltonian(ctx["h_mo"], ctx["g_mo"], na, nb)
    n = ctx["n"]
    sa, sb = _strings(n, na), _strings(n, nb)
    dets = [a | (b << n) for a in sa for b in sb]
    index = {m: i for i, m in enumerate(dets)}
    Tm = _t_matrix(ctx["t1"], ctx["t2"], n, ctx["na"], ctx["nb"], dets, index)
    Xi, X = _expm_nilpotent(-Tm), _expm_nilpotent(Tm)
    Hbar = Xi @ H @ X
    if return_transforms:
        return Hbar, dets, index, Xi, X
    return Hbar, dets


def _one_body_matrix(op_mo: np.ndarray, n: int, dets, index) -> np.ndarray:
    """Dense determinant-basis matrix of the spin-free one-body operator
    sum_pq op[p,q] (a+_pa a_qa + a+_pb a_qb); spatial-orbital MO matrix in,
    alpha bits [0, n), beta bits [n, 2n)."""
    dim = len(dets)
    M = np.zeros((dim, dim))
    pq = list(zip(*np.nonzero(np.abs(op_mo) > 1e-14)))
    for col, mask in enumerate(dets):
        for p, q in pq:
            for off in (0, n):
                r = _annihilate(mask, q + off)
                if r is None:
                    continue
                s1, m1 = r
                r = _create(m1, p + off)
                if r is None:
                    continue
                s2, m2 = r
                M[index[m2], col] += s1 * s2 * op_mo[p, q]
    return M


def ip_eom_ccsd(
    system: MolecularSystem,
    config: Optional[HartreeFockConfig] = None,
    *,
    nstates: int = 3,
    max_dim: int = 4000,
    cc_epsilon: float = 1e-10,
    device="cuda",
) -> IpEaOutput:
    """IP-EOM-CCSD: ionization potentials from the (N-1)-electron sector
    of Hbar, projected onto 1h and 2h1p determinants. Positive energies =
    energy to remove an electron (alpha channel)."""
    return _ip_ea(system, config, nstates, max_dim, cc_epsilon, "ip", device)


def ea_eom_ccsd(
    system: MolecularSystem,
    config: Optional[HartreeFockConfig] = None,
    *,
    nstates: int = 3,
    max_dim: int = 4000,
    cc_epsilon: float = 1e-10,
    device="cuda",
) -> IpEaOutput:
    """EA-EOM-CCSD: electron affinities from the (N+1)-electron sector of
    Hbar, projected onto 1p and 2p1h determinants. Negative values mean
    the anion is bound."""
    return _ip_ea(system, config, nstates, max_dim, cc_epsilon, "ea", device)


def _ip_ea(system, config, nstates, max_dim, cc_epsilon, kind, device):
    ctx = _cc_context(system, config, max_dim, cc_epsilon, device)
    na, nb = ctx["na"], ctx["nb"]
    Hbar, dets = _hbar_sector(ctx, na - 1 if kind == "ip" else na + 1, nb)
    hf = ctx["hf_mask"]
    # particles/holes relative to the N-electron HF determinant
    parts = np.array([bin(m & ~hf).count("1") for m in dets])
    holes = np.array([bin(hf & ~m).count("1") for m in dets])
    keep = np.where(parts <= 1)[0] if kind == "ip" else np.where(holes <= 1)[0]
    Hp = Hbar[np.ix_(keep, keep)]
    w = np.sort(np.linalg.eigvals(Hp).real) + float(system.nuclear_repulsion())
    e_cc = ctx["e_ccsd"]
    vals = w[:nstates] - e_cc  # IPs positive; EA convention E(N+1) - E(N)
    koopmans = -float(ctx["eps"][na - 1]) if kind == "ip" else float(ctx["eps"][na])
    return IpEaOutput(ccsd_total_energy=e_cc, energies=np.asarray(vals), kind=kind,
                      dimension=len(keep), koopmans=koopmans)


def _closed_shell_rhf(system, config, device):
    """(config, RHF output, na, nb) of a closed-shell EOM run."""
    config = config or HartreeFockConfig(epsilon=1e-10, max_iterations=200)
    na, nb = scf.electron_counts(system.n_electrons(config.charge), config.spin_multiplicity)
    if na != nb:
        raise ValueError("EOM requires a closed-shell RHF reference")
    out = restricted_hartree_fock(system, config, device=device)
    if not out.converged:
        raise RuntimeError("SCF not converged")
    return config, out, na, nb


def _cc_context(system, config, max_dim, cc_epsilon, device):
    """Shared setup: RHF, spinorbital CCSD amplitudes, MO integrals, and
    the N-electron reference bookkeeping."""
    device = check_device(device)
    config, out, na, nb = _closed_shell_rhf(system, config, device)
    C = torch.as_tensor(out.coefficients, dtype=torch.float64, device=device)
    eps = np.asarray(out.orbital_energies)
    n = C.shape[1]
    if math.comb(n, na) * math.comb(n, nb) > max_dim:
        raise ValueError("determinant space exceeds max_dim")

    e4 = _incore_e4(system, config, device)
    _, _, _, _, _, res = spinorbital_amplitudes(e4, C, C, eps, eps, na, nb, 0, 200, cc_epsilon)
    t1, t2, e_corr, iters, converged = res
    if not converged:
        raise RuntimeError("CCSD amplitudes not converged")
    _, H1, _, _ = core_hamiltonian(system, device)
    return {
        "n": n, "na": na, "nb": nb, "C": C.cpu().numpy(), "eps": eps,
        "h_mo": (C.T @ H1 @ C).cpu().numpy(), "g_mo": _transform_full(e4, C).cpu().numpy(),
        "t1": t1.cpu().numpy(), "t2": t2.cpu().numpy(), "cc_iters": iters,
        "e_ccsd": out.total_energy() + e_corr,
        "hf_mask": ((1 << na) - 1) | (((1 << nb) - 1) << n),
        "scf_total_energy": out.total_energy(),
    }


# --------------------------------------------------------------------------
# matrix-free EOM-EE-CCSD: sigma vectors as the jvp of the CCSD residual
# --------------------------------------------------------------------------


def _davidson_nonsym_lowest(
    matvec,
    diag: torch.Tensor,
    k: int,
    *,
    in_subspace,
    tol: float = 1e-6,
    max_iter: int = 100,
    max_subspace: int = 0,
):
    """Lowest-k right eigenpairs of an implicit (mildly) non-Hermitian
    matrix by block Davidson with oblique Rayleigh-Ritz (np.linalg.eig on
    the projected matrix, on the host). ``in_subspace`` projects a (dim, m)
    block onto the physical subspace (Ms-conserving, antisymmetric or
    symmetric amplitude patterns) — the operator preserves it, so every
    basis vector passes through it once at entry. The basis and its images
    stay on ``diag``'s device. Returns (w numpy, X (dim, k) tensor,
    converged)."""
    dim = diag.numel()
    k = min(k, dim)
    max_subspace = max_subspace or max(6 * k, 48)
    nb = min(dim, max(2 * k, k + 4))
    V = diag.new_empty((dim, 0))
    AV = diag.new_empty((dim, 0))

    def _extend(B):
        nonlocal V, AV
        keep = _orthonormal_columns(B, V)
        if not keep:
            return False
        B = torch.stack(keep, dim=1)
        AB = matvec(B.T.contiguous()).T
        V = torch.cat([V, B], dim=1)
        AV = torch.cat([AV, AB], dim=1)
        return True

    _extend(in_subspace(_start_block(diag, nb)))
    w = X = None
    for _ in range(max_iter):
        T = (V.T @ AV).cpu().numpy()
        w_all, S_all = np.linalg.eig(T)
        # the projected start basis can hold fewer than k independent
        # columns in early iterations — work with what exists
        kk = min(k, w_all.size)
        sel = np.argsort(w_all.real)[:kk]
        w = w_all[sel].real
        S = np.real(S_all[:, sel])
        # renormalize (real part of a complex eigvec can shrink)
        S = S / np.maximum(np.linalg.norm(S, axis=0), 1e-30)
        S = torch.as_tensor(S, device=V.device)
        X = V @ S
        R = AV @ S - X * torch.as_tensor(w, device=V.device)
        rn = torch.linalg.norm(R, dim=0).cpu().numpy()
        if kk == k and np.all(rn < tol):
            return w, X, True
        new = _preconditioned(R, w, diag, rn, tol)
        if not new:
            # every present root converged but kk < k: inject fresh
            # directions so the subspace can still reach k roots
            rng_l = np.random.default_rng(V.shape[1])
            new.append(torch.as_tensor(rng_l.standard_normal(dim), device=V.device))
        B = in_subspace(torch.stack(new, dim=1))
        if V.shape[1] + B.shape[1] > max_subspace:
            V, AV = diag.new_empty((dim, 0)), diag.new_empty((dim, 0))
            _extend(in_subspace(_host_qr(X)))
        if not _extend(B):
            return w, X, True  # stagnated at numerical precision
    return w, X, False


def _spinorbital_projector(na, nb, n, no, nv, device):
    """The Ms / antisymmetry projector of spinorbital (r1, r2) columns."""
    spin_o = np.array([0] * na + [1] * nb)
    spin_v = np.array([0] * (n - na) + [1] * (n - nb))
    mask1 = torch.as_tensor((spin_o[:, None] == spin_v[None, :]).astype(float), device=device)
    mask2 = torch.as_tensor(((spin_o[:, None, None, None] + spin_o[None, :, None, None])
                             == (spin_v[None, None, :, None] + spin_v[None, None, None, :])
                             ).astype(float), device=device)
    n1 = no * nv

    def in_subspace(B):
        m = B.shape[1]
        r1 = B[:n1].T.reshape(m, no, nv) * mask1
        r2 = B[n1:].T.reshape(m, no, no, nv, nv)
        r2 = 0.25 * (r2 - r2.transpose(1, 2) - r2.transpose(3, 4)
                     + r2.permute(0, 2, 1, 4, 3)) * mask2
        return torch.cat([r1.reshape(m, -1), r2.reshape(m, -1)], dim=1).T

    return in_subspace


def _spatial_projector(no, nv):
    """The (i a) <-> (j b) symmetrizer of spatial (r1, r2) columns."""
    n1 = no * nv

    def in_subspace(B):
        m = B.shape[1]
        r2 = B[n1:].T.reshape(m, no, no, nv, nv)
        r2 = 0.5 * (r2 + r2.permute(0, 2, 1, 4, 3))
        return torch.cat([B[:n1], r2.reshape(m, -1).T])

    return in_subspace


def _sigma(G, amps, shape1, shape2):
    """Right sigma vectors: one jvp of the residual G per row of X."""
    n1 = math.prod(shape1)

    def matvec(X):
        rows = []
        for x in X:
            _, (s1, s2) = jvp(G, amps, (x[:n1].reshape(shape1), x[n1:].reshape(shape2)))
            rows.append(torch.cat([s1.reshape(-1), s2.reshape(-1)]))
        return torch.stack(rows)

    return matvec


def _sigma_left(G, amps, shape1, shape2, in_subspace):
    """Left sigma vectors: the transposed Jacobian, one vjp per row,
    projected back onto the physical subspace. The Jacobian J keeps that
    subspace but J^T need not (the amplitude step reads t2 in full), so the
    left operator is P J^T P: without the projection the residual keeps a
    component outside the basis's span and never falls below ``tol``
    (spinorbital water/6-31G in the JAX package). P J^T P = (P J P)^T has
    the right spectrum."""
    n1 = math.prod(shape1)
    _, vjp_fun = vjp(G, *amps)

    def matvec(X):
        rows = []
        for x in X:
            d1, d2 = vjp_fun((x[:n1].reshape(shape1), x[n1:].reshape(shape2)))
            rows.append(torch.cat([d1.reshape(-1), d2.reshape(-1)]))
        return in_subspace(torch.stack(rows).T).T

    return matvec


def eom_ccsd_davidson(
    system: MolecularSystem,
    config: Optional[HartreeFockConfig] = None,
    *,
    nstates: int = 5,
    formulation: str = "spinorbital",
    tol: float = 1e-6,
    cc_epsilon: float = 1e-10,
    left: bool = False,
    device="cuda",
) -> EomOutput:
    """Matrix-free EOM-EE-CCSD: Davidson over jvp sigma vectors.
    ``formulation="spinorbital"`` covers all Ms=0 roots (singlets and
    triplets); ``"spatial"`` runs the closed-shell fast path and finds
    singlet roots only. ``left=True`` also solves the left eigenproblem
    (one vjp per sigma vector); its excitation energies land in
    ``left_excitation_energies`` and must match the right spectrum."""
    device = check_device(device)
    if formulation not in ("spinorbital", "spatial"):
        raise ValueError(f"unknown formulation={formulation!r}")
    config, out, na, nb = _closed_shell_rhf(system, config, device)
    C = torch.as_tensor(out.coefficients, dtype=torch.float64, device=device)
    eps = np.asarray(out.orbital_energies)
    n = C.shape[1]
    e4 = _incore_e4(system, config, device)

    if formulation == "spinorbital":
        W, eps_o, eps_v, no, _, res = spinorbital_amplitudes(e4, C, C, eps, eps, na, nb, 0, 200,
                                                             cc_epsilon)
        del e4
        t1, t2, e_corr, iters, converged = res
        if not converged:
            raise RuntimeError("CCSD amplitudes not converged")
        G_ft, _, (D1, D2) = _residual_fns(eps_o, eps_v, no, W)

        def G(a, b):
            return G_ft((a, b))

        nv = eps_v.shape[0]
        in_subspace = _spinorbital_projector(na, nb, n, no, nv, device)
    else:
        g = _mo_phys_blocks(e4, C[:, :na], C[:, na:])
        del e4
        eps_o = torch.as_tensor(eps[:na], dtype=torch.float64, device=device)
        eps_v = torch.as_tensor(eps[na:], dtype=torch.float64, device=device)
        D1 = eps_o[:, None] - eps_v[None, :]
        D2 = _d2(eps_o, eps_v)
        _, (t1, t2, e_corr, iters, converged) = spatial_amplitudes(g, eps_o, eps_v, 200,
                                                                   cc_epsilon)
        if not converged:
            raise RuntimeError("CCSD amplitudes not converged")

        def G(a, b):
            t1n, Tn, _ = _ccsd_rhf_step(a, b, eps_o, eps_v, g)
            return D1 * (t1n - a), D2 * (Tn - b)

        no, nv = eps_o.shape[0], eps_v.shape[0]
        in_subspace = _spatial_projector(no, nv)

    amps = (t1, t2)
    shape1, shape2 = (no, nv), (no, no, nv, nv)
    diag = torch.cat([(-D1).reshape(-1), (-D2).reshape(-1)])
    # oversolve: near-degenerate pairs are easy for Davidson to skip when
    # asked for exactly k roots (water's 0.5018/0.5055 pair)
    k_int = nstates + 2
    w, X, ok = _davidson_nonsym_lowest(_sigma(G, amps, shape1, shape2), diag, k_int,
                                       in_subspace=in_subspace, tol=tol)
    if not ok:
        raise RuntimeError("EOM Davidson did not converge")
    wl = None
    if left:
        left_mv = _sigma_left(G, amps, shape1, shape2, in_subspace)
        wl, _XL, okl = _davidson_nonsym_lowest(left_mv, diag, k_int, in_subspace=in_subspace,
                                               tol=tol)
        if not okl:
            raise RuntimeError("left EOM Davidson did not converge")
        wl = np.asarray(wl)[:nstates]
    return EomOutput(
        scf_total_energy=out.total_energy(),
        ccsd_total_energy=out.total_energy() + e_corr,
        excitation_energies=np.asarray(w)[:nstates],
        dimension=diag.numel(),
        fci_dimension=0,
        cc_iterations=iters,
        amplitude_residual=0.0,
        left_excitation_energies=wl,
    )


def eom_ccsd(
    system: MolecularSystem,
    config: Optional[HartreeFockConfig] = None,
    *,
    nstates: int = 5,
    max_dim: int = 4000,
    cc_epsilon: float = 1e-10,
    device="cuda",
) -> EomOutput:
    """EOM-CCSD excitation energies on a closed-shell RHF reference
    (determinant tier)."""
    ctx = _cc_context(system, config, max_dim, cc_epsilon, device)
    na, nb = ctx["na"], ctx["nb"]
    Hbar, dets = _hbar_sector(ctx, na, nb)
    hf = ctx["hf_mask"]
    assert dets[0] == hf  # lexicographic strings put the HF det first
    ranks = np.array([bin(m ^ hf).count("1") // 2 for m in dets])
    keep = np.where(ranks <= 2)[0]
    Hp = Hbar[np.ix_(keep, keep)]

    e_nuc = float(system.nuclear_repulsion())
    e0 = Hbar[0, 0] + e_nuc  # = E_CCSD (consistency anchor)
    residual = float(np.max(np.abs(Hp[1:, 0])))
    w = np.sort(np.linalg.eigvals(Hp).real) + e_nuc
    # the lowest root is the CC ground state; excitations are relative
    omega = w[1:] - w[0]
    k = min(nstates, omega.shape[0])
    return EomOutput(
        scf_total_energy=ctx["scf_total_energy"],
        ccsd_total_energy=float(e0),
        excitation_energies=omega[:k],
        dimension=len(keep),
        fci_dimension=len(dets),
        cc_iterations=ctx["cc_iters"],
        amplitude_residual=residual,
    )


@dataclasses.dataclass
class EomPropertiesOutput:
    scf_total_energy: float
    ccsd_total_energy: float
    excitation_energies: np.ndarray  # (nstates,) Hartree, ascending
    oscillator_strengths: np.ndarray  # (nstates,) length-gauge f values
    transition_strengths: np.ndarray  # (nstates, 3) S_d = T_L,d * T_R,d
    ground_state_dipole: np.ndarray  # (3,) a.u., nuclear + electronic
    dimension: int

    def excitation_energies_ev(self) -> np.ndarray:
        return self.excitation_energies * HARTREE_TO_EV


def eom_ccsd_properties(
    system: MolecularSystem,
    config: Optional[HartreeFockConfig] = None,
    *,
    nstates: int = 5,
    max_dim: int = 4000,
    cc_epsilon: float = 1e-10,
    device="cuda",
) -> EomPropertiesOutput:
    """EOM-CCSD transition dipoles and oscillator strengths, exact in the
    determinant-space tier. With right eigenvectors R_k and their duals
    L = R^{-1},

        S_k,d = <L_0| mubar_d |R_k> <L_k| mubar_d |R_0>,
        f_k   = (2/3) omega_k sum_d S_k,d,

    where mubar = e^{-T} mu e^{T} is built with the same nilpotent
    expansions as Hbar. The ground-state row <L_0|mubar|R_0> + mu_nuc is
    the Lambda-equation dipole."""
    ctx = _cc_context(system, config, max_dim, cc_epsilon, device)
    na, nb = ctx["na"], ctx["nb"]
    Hbar, dets, index, Xi, X = _hbar_sector(ctx, na, nb, return_transforms=True)
    hf = ctx["hf_mask"]
    ranks = np.array([bin(m ^ hf).count("1") // 2 for m in dets])
    keep = np.where(ranks <= 2)[0]
    sel = np.ix_(keep, keep)
    Hp = Hbar[sel]

    C = ctx["C"]
    mu_ao = one_electron.dipole_integrals(system, check_device(device)).cpu().numpy()
    # electrons carry charge -1: electronic dipole operator is -r
    mubar = [(Xi @ _one_body_matrix(-(C.T @ mu_ao[d] @ C), ctx["n"], dets, index) @ X)[sel]
             for d in range(3)]

    w, R = np.linalg.eig(Hp)
    order = np.argsort(w.real)
    w = w[order]
    R = R[:, order]
    L = np.linalg.inv(R)  # rows are the biorthonormal left eigenvectors
    omega = (w[1:] - w[0]).real
    k = min(nstates, omega.shape[0])

    mu_gs = np.array([(L[0] @ mubar[d] @ R[:, 0]).real for d in range(3)]) + _nuclear_dipole(system)
    strengths = np.zeros((k, 3))
    for j in range(k):
        s = j + 1  # state index in the sorted spectrum
        for d in range(3):
            t_r = L[0] @ mubar[d] @ R[:, s]
            t_l = L[s] @ mubar[d] @ R[:, 0]
            strengths[j, d] = (t_r * t_l).real
    f = (2.0 / 3.0) * omega[:k] * strengths.sum(axis=1)
    return EomPropertiesOutput(
        scf_total_energy=ctx["scf_total_energy"],
        ccsd_total_energy=float(Hbar[0, 0] + float(system.nuclear_repulsion())),
        excitation_energies=omega[:k],
        oscillator_strengths=f,
        transition_strengths=strengths,
        ground_state_dipole=mu_gs,
        dimension=len(keep),
    )


def _flat(ts) -> torch.Tensor:
    return torch.cat([ts[0].reshape(-1), ts[1].reshape(-1)])


def eom_ccsd_transition_moments(
    system: MolecularSystem,
    config: Optional[HartreeFockConfig] = None,
    *,
    nstates: int = 5,
    tol: float = 1e-7,
    cc_epsilon: float = 1e-10,
    device="cuda",
) -> EomPropertiesOutput:
    """Matrix-free EOM-CCSD transition dipoles and oscillator strengths
    (Davidson + differentiation through the amplitude residual; no
    determinant space). Per Cartesian direction d, S_kd = T^L_kd T^R_kd:

    - T^L_kd = l_k . xi_d, with xi_d = dG/df . mu_d (one jvp over the
      one-body blocks);
    - T^R_kd = eta_d . r + lambda . (dxi_d/dt . r)
               + lambda_2 . P2(r_1, xi_d,1) - (lambda . r)(lambda . xi_d),
      with eta_d = grad_t(dE/df . mu_d), dxi_d/dt . r a nested jvp, and
      P2 = A(r_1 x xi_1) the disconnected doubles piece.

    Spinorbital formulation (all Ms = 0 roots; triplets come out with
    numerically zero strength)."""
    device = check_device(device)
    config, out, na, nb = _closed_shell_rhf(system, config, device)
    C = torch.as_tensor(out.coefficients, dtype=torch.float64, device=device)
    eps = np.asarray(out.orbital_energies)
    n = C.shape[1]
    e4 = _incore_e4(system, config, device)
    W, eps_o, eps_v, no, _, res = spinorbital_amplitudes(e4, C, C, eps, eps, na, nb, 0, 200,
                                                         cc_epsilon)
    del e4
    t1, t2, e_corr, iters, converged = res
    if not converged:
        raise RuntimeError("CCSD amplitudes not converged")
    t = (t1, t2)
    nv = eps_v.shape[0]
    G, E_corr_fn, (D1, D2) = _residual_fns(eps_o, eps_v, no, W)
    lam, _ = _solve_lambda({"G": G, "E": E_corr_fn, "t": t, "D": (D1, D2)})

    def G_t(a, b):
        return G((a, b))

    shape1, shape2 = (no, nv), (no, no, nv, nv)
    n1 = no * nv
    in_subspace = _spinorbital_projector(na, nb, n, no, nv, device)
    diag = torch.cat([(-D1).reshape(-1), (-D2).reshape(-1)])
    k_int = nstates + 2
    w, XR, ok = _davidson_nonsym_lowest(_sigma(G_t, t, shape1, shape2), diag, k_int,
                                        in_subspace=in_subspace, tol=tol)
    if not ok:
        raise RuntimeError("EOM Davidson (right) did not converge")
    wl, XL, okl = _davidson_nonsym_lowest(_sigma_left(G_t, t, shape1, shape2, in_subspace),
                                          diag, k_int, in_subspace=in_subspace, tol=tol)
    if not okl:
        raise RuntimeError("EOM Davidson (left) did not converge")

    # pair left roots to right roots by eigenvalue, then biorthonormalize
    k = min(nstates, w.size)
    pairs = []
    used = set()
    for s in range(k):
        cand = np.argsort(np.abs(wl - w[s]))
        j = next(int(c) for c in cand if int(c) not in used)
        used.add(j)
        if abs(wl[j] - w[s]) > 100 * tol + 1e-9:
            raise RuntimeError(f"left/right spectra disagree: {w[s]:.8f} vs {wl[j]:.8f}")
        pairs.append(j)

    # --- dipole derivative ingredients --------------------------------------
    mu_ao = one_electron.dipole_integrals(system, device)  # (3, nao, nao)
    ctx_mo = {"C": C, "na": na}
    f64 = dict(dtype=torch.float64, device=device)
    zeros = (torch.zeros((2 * na, 2 * na), **f64), torch.zeros((2 * na, 2 * (n - na)), **f64),
             torch.zeros((2 * (n - na), 2 * (n - na)), **f64))
    D_hf = torch.as_tensor(out.density, **f64)
    mu_nuc = _nuclear_dipole(system)
    lam_v = _flat(lam)
    strengths = np.zeros((k, 3))
    mu_gs = np.zeros(3)
    for d in range(3):
        f_d = _mo_blocks(ctx_mo, -mu_ao[d])  # electron charge -1
        _, xi = jvp(lambda ff: G(t, ff), (zeros,), (f_d,))
        eta = grad(lambda ts: jvp(lambda ff: E_corr_fn(ts, ff), (zeros,), (f_d,))[1])(t)
        xi_v, eta_v = _flat(xi), _flat(eta)
        lam_xi = float(lam_v @ xi_v)
        # ground-state (unrelaxed Lambda) dipole: reference + correlation
        e_ref = float(torch.sum(D_hf * -mu_ao[d]))
        de = float(jvp(lambda ff: E_corr_fn(t, ff), (zeros,), (f_d,))[1])
        mu_gs[d] = e_ref + de + lam_xi + mu_nuc[d]

        xi1 = xi[0]
        for s in range(k):
            r_v = XR[:, s]
            l_v = XL[:, pairs[s]]
            l_v = l_v / float(l_v @ r_v)  # biorthonormal pair
            t_left = float(l_v @ xi_v)
            r1, r2 = r_v[:n1].reshape(shape1), r_v[n1:].reshape(shape2)
            _, dxi = jvp(lambda ts: jvp(lambda ff: G(ts, ff), (zeros,), (f_d,))[1], (t,),
                         ((r1, r2),))
            P2 = (torch.einsum("ia,jb->ijab", r1, xi1) - torch.einsum("ja,ib->ijab", r1, xi1)
                  - torch.einsum("ib,ja->ijab", r1, xi1) + torch.einsum("jb,ia->ijab", r1, xi1))
            lam_r = float(lam_v @ r_v)
            t_right = (float(eta_v @ r_v) + float(lam_v @ _flat(dxi))
                       + float(lam[1].reshape(-1) @ P2.reshape(-1)) - lam_r * lam_xi)
            strengths[s, d] = t_left * t_right

    omega = np.asarray(w)[:k]
    f_osc = (2.0 / 3.0) * omega * strengths.sum(axis=1)
    return EomPropertiesOutput(
        scf_total_energy=out.total_energy(),
        ccsd_total_energy=out.total_energy() + e_corr,
        excitation_energies=omega,
        oscillator_strengths=f_osc,
        transition_strengths=strengths,
        ground_state_dipole=mu_gs,
        dimension=diag.numel(),
    )
