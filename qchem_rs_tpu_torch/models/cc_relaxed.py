"""Orbital-relaxed CCSD first-order properties by the z-vector method (port
of ``qchem_rs_tpu/models/cc_relaxed.py``).

The unrelaxed CC expectation (``cc_lambda``) holds the HF orbitals fixed;
the derivative dE_CC/dtheta also carries the orbitals' response. The
z-vector trick (Handy-Schaefer) solves one transposed system instead of
CPHF per perturbation:

    L(t, lam, z, kappa; theta) = E_corr(t; kappa, theta)
                                 + lam . G(t; kappa, theta)
                                 + z . g_HF(kappa, theta)

with kappa the occupied-virtual orbital rotation and g_HF = F_ov the HF
stationarity condition. Stationarity in kappa fixes z from

    A^T z = -(d/dkappa)[E_corr + lam . G]        (A = d g_HF / d kappa)

and then dE/dtheta = dL/dtheta at frozen (t, lam, z, kappa=0). Everything
on the right is ``torch.func`` differentiation: the MO-integral rotation
through ``_spinorbital_setup``, the residual through the general-f CCSD
step, A^T through one ``vjp`` of g_HF, and the theta derivatives through
``jvp``. The z system is solved by ``models/gmres.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch.func import grad, jvp, vjp

from qchem_rs_tpu_torch.config import HartreeFockConfig
from qchem_rs_tpu_torch.models.cc import _ccsd_step, _d2, _spinorbital_setup
from qchem_rs_tpu_torch.models.cc_lambda import (_nuclear_dipole, _setup, _solve_lambda,
                                                 _unrelaxed_dipole)
from qchem_rs_tpu_torch.models.gmres import gmres
from qchem_rs_tpu_torch.models.properties import dipole_moment
from qchem_rs_tpu_torch.models.rhf import check_device
from qchem_rs_tpu_torch.ops import one_electron
from qchem_rs_tpu_torch.utils.system import MolecularSystem


@dataclasses.dataclass
class RelaxedPropertyOutput:
    scf_total_energy: float
    ccsd_total_energy: float
    scf_dipole: np.ndarray  # (3,) a.u.
    ccsd_dipole_unrelaxed: np.ndarray  # (3,) a.u. (Lambda expectation)
    ccsd_dipole: np.ndarray  # (3,) a.u., orbital-relaxed
    z_residual: float


def ccsd_relaxed_dipole(
    system: MolecularSystem,
    config: Optional[HartreeFockConfig] = None,
    *,
    cc_epsilon: float = 1e-10,
    z_tol: float = 1e-9,
    device="cuda",
) -> RelaxedPropertyOutput:
    """Orbital-relaxed CCSD dipole moment (plus the unrelaxed and SCF
    dipoles for comparison). One lambda solve and one z-vector solve serve
    all three Cartesian components; the unrelaxed dipole comes from the
    same amplitudes and lambda."""
    config = config or HartreeFockConfig(epsilon=1e-10, max_iterations=200)
    device = check_device(device)
    ctx = _setup(system, config, cc_epsilon, device)
    lam, _ = _solve_lambda(ctx)
    out = ctx["out"]
    C, e4 = ctx["C"], ctx["e4"]
    eps = np.asarray(out.orbital_energies)
    na = ctx["na"]
    n = C.shape[1]
    nv_sp = n - na
    t = ctx["t"]

    f64 = dict(dtype=torch.float64, device=device)
    H_ao = one_electron.kinetic(system, device) + one_electron.nuclear(system, device)
    mu_ao = one_electron.dipole_integrals(system, device)  # (3, n, n) of r

    # spin duplication of spatial one-body blocks, as one-hot products (no
    # gather, whose backward would add into repeated rows with atomics)
    occ_sp = np.concatenate([np.arange(na), np.arange(na)])
    vir_sp = np.concatenate([np.arange(na, n), np.arange(na, n)])
    P_o = torch.as_tensor(np.arange(n)[None, :] == occ_sp[:, None], **f64)
    P_v = torch.as_tensor(np.arange(n)[None, :] == vir_sp[:, None], **f64)
    so = np.array([0] * na + [1] * na)
    sv = np.array([0] * nv_sp + [1] * nv_sp)
    m_oo = torch.as_tensor((so[:, None] == so[None, :]).astype(float), **f64)
    m_ov = torch.as_tensor((so[:, None] == sv[None, :]).astype(float), **f64)
    m_vv = torch.as_tensor((sv[:, None] == sv[None, :]).astype(float), **f64)
    eps_t = torch.as_tensor(eps, **f64)
    eps_so_o = torch.cat([eps_t[:na], eps_t[:na]])
    eps_so_v = torch.cat([eps_t[na:], eps_t[na:]])
    D1 = eps_so_o[:, None] - eps_so_v[None, :]
    D2 = _d2(eps_so_o, eps_so_v)
    eye = torch.eye(n, **f64)

    def rotate(kappa):
        """C(kappa) to first order: kappa is the spatial (nv, no) vo block
        of the antisymmetric generator (exact first derivatives at 0)."""
        K = torch.cat([torch.cat([torch.zeros((na, na), **f64), -kappa.T], dim=1),
                       torch.cat([kappa, torch.zeros((nv_sp, nv_sp), **f64)], dim=1)])
        return C @ (eye + K)

    def fock_ao(Cr, theta):
        """AO Fock at the rotated density with field coupling H + theta.r
        (electron charge -1 convention of models/rhf._field_terms)."""
        Docc = 2.0 * (Cr[:, :na] @ Cr[:, :na].T)
        J = torch.einsum("pqrs,rs->pq", e4, Docc)
        K = torch.einsum("prqs,rs->pq", e4, Docc)
        H1 = H_ao + torch.einsum("d,dpq->pq", theta, mu_ao)
        return H1 + J - 0.5 * K

    def g_hf(kappa, theta):
        """HF stationarity: the occ-virt MO Fock block (spatial, (na, nv))."""
        Cr = rotate(kappa)
        F = Cr.T @ fock_ao(Cr, theta) @ Cr
        return F[:na, na:]

    def corr_lagrangian(kappa, theta):
        """E_corr + lam . G with every MO quantity rebuilt from C(kappa)
        and the field-dependent Fock; the one-body rest R = F_mo - diag(eps)
        flows through the general-f CCSD step (exact for any split)."""
        Cr = rotate(kappa)
        W, eps_o, eps_v, no, _nv = _spinorbital_setup(e4, Cr, Cr, eps, eps, na, na, 0)
        Fmo = Cr.T @ fock_ao(Cr, theta) @ Cr
        R = Fmo - torch.diag(eps_t)
        f = (m_oo * (P_o @ R @ P_o.T), m_ov * (P_o @ R @ P_v.T), m_vv * (P_v @ R @ P_v.T))
        a, b = t
        t1n, t2n, _ = _ccsd_step(a, b, eps_o, eps_v, no, W, f)
        G1 = D1 * (t1n - a)
        G2 = D2 * (t2n - b)
        Woovv = W[:no, :no, no:, no:]
        e = (0.25 * torch.einsum("ijab,ijab->", Woovv, b)
             + 0.5 * torch.einsum("ijab,ia,jb->", Woovv, a, a)
             + torch.einsum("ia,ia->", f[1], a))
        return e + torch.sum(lam[0] * G1) + torch.sum(lam[1] * G2)

    kappa0 = torch.zeros((nv_sp, na), **f64)
    theta0 = torch.zeros(3, **f64)

    # z-vector: A^T z = -b, b = d(corr Lagrangian)/d kappa at 0
    b = grad(corr_lagrangian, argnums=0)(kappa0, theta0)
    _, vjp_g = vjp(lambda k: g_hf(k, theta0), kappa0)

    # z lives in the g-space (na, nv); kappa/b live in (nv, na). GMRES
    # needs an endomorphism, so solve for z^T in kappa space and transpose.
    def At(zk):
        return vjp_g(zk.T.contiguous())[0]

    # preconditioner: the CPHF diagonal ~ 2(eps_a - eps_i) in kappa space
    d_k = 2.0 * (eps_t[na:][:, None] - eps_t[:na][None, :])
    zk, _info = gmres(At, -b, M=lambda v: v / d_k, tol=z_tol, maxiter=200, restart=40)
    z = zk.T
    z_res = float(torch.linalg.norm(At(zk) + b))
    if z_res > 1e-6 * max(float(torch.linalg.norm(b)), 1.0):
        raise RuntimeError(f"z-vector GMRES residual {z_res:.2e}")

    # dE/dtheta at frozen (t, lam, z, kappa=0), one jvp per direction
    D_hf = torch.as_tensor(out.density, **f64)

    def total_theta_terms(theta):
        # HF part: at kappa=0 the only explicit theta term is tr(D theta.r)
        e_hf = torch.einsum("pq,d,dpq->", D_hf, theta, mu_ao)
        return e_hf + corr_lagrangian(kappa0, theta) + torch.sum(z * g_hf(kappa0, theta))

    dE = np.array([float(jvp(total_theta_terms, (theta0,), (eye3,))[1])
                   for eye3 in torch.eye(3, **f64)])
    # coupling H += theta.r  =>  mu_elec = -<r> = -dE/dtheta
    mu_relaxed = _nuclear_dipole(system) - dE
    return RelaxedPropertyOutput(
        scf_total_energy=out.total_energy(),
        ccsd_total_energy=out.total_energy() + ctx["e_corr"],
        scf_dipole=np.asarray(dipole_moment(system, out.density, device)),
        ccsd_dipole_unrelaxed=_unrelaxed_dipole(system, ctx, lam),
        ccsd_dipole=mu_relaxed,
        z_residual=z_res,
    )
