"""CCSD Lambda equations and analytic one-electron properties by automatic
differentiation (port of ``qchem_rs_tpu/models/cc_lambda.py``).

The CC Lagrangian L(t, lam; theta) = E(t; theta) + lam . G(t; theta) is
stationary in t and lam, so first-order properties need no density
diagrams:

    dE/dtheta = dE/dtheta|_t + lam . dG/dtheta|_t,

with lam from one linear solve, J^T lam = -dE/dt (J = dG/dt). Every piece
is ``torch.func`` differentiation through the CCSD residual of
``models/cc.py``: J^T by ``vjp``, dE/dt by ``grad``, dG/dtheta by ``jvp``
over the general one-electron blocks the amplitude step accepts
(``f=(foo, fov, fvv)``). Preconditioned GMRES (``models/gmres.py``, with
the orbital-energy-difference diagonal) solves the lambda system.

These are unrelaxed properties (fixed HF orbitals); ``cc_relaxed`` adds
the orbital response.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch.func import grad, jvp, vjp

from qchem_rs_tpu_torch.config import HartreeFockConfig
from qchem_rs_tpu_torch.models import scf
from qchem_rs_tpu_torch.models.cc import _ccsd_step, _d2, _incore_e4, spinorbital_amplitudes
from qchem_rs_tpu_torch.models.gmres import gmres
from qchem_rs_tpu_torch.models.properties import dipole_moment
from qchem_rs_tpu_torch.models.rhf import check_device, restricted_hartree_fock
from qchem_rs_tpu_torch.ops import one_electron
from qchem_rs_tpu_torch.utils.system import MolecularSystem


@dataclasses.dataclass
class CcPropertyOutput:
    scf_total_energy: float
    ccsd_total_energy: float
    scf_dipole: np.ndarray  # (3,) a.u.
    ccsd_dipole: np.ndarray  # (3,) a.u., unrelaxed
    lambda_iterations: int


def _residual_fns(eps_o, eps_v, no, W):
    """The residual G(t; f) = D * (t' - t) of the amplitude step, and the
    correlation energy E(t; f), for a spinorbital W."""
    D1 = eps_o[:, None] - eps_v[None, :]
    D2 = _d2(eps_o, eps_v)
    Woovv = W[:no, :no, no:, no:]

    def G(ts, f=None):
        a, b = ts
        t1n, t2n, _ = _ccsd_step(a, b, eps_o, eps_v, no, W, f)
        return (D1 * (t1n - a), D2 * (t2n - b))

    def E(ts, f=None):
        a, b = ts
        e = (0.25 * torch.einsum("ijab,ijab->", Woovv, b)
             + 0.5 * torch.einsum("ijab,ia,jb->", Woovv, a, a))
        if f is not None:
            e = e + torch.einsum("ia,ia->", f[1], a)
        return e

    return G, E, (D1, D2)


def _setup(system, config, cc_epsilon, device):
    """Converged spinorbital amplitudes of a closed shell on its RHF, and
    the residual/energy closures, on ``device``."""
    na, nb = scf.electron_counts(system.n_electrons(config.charge), config.spin_multiplicity)
    if na != nb:
        raise ValueError("cc properties require a closed-shell RHF reference")
    out = restricted_hartree_fock(system, config, device=device)
    if not out.converged:
        raise RuntimeError("SCF not converged")
    C = torch.as_tensor(out.coefficients, dtype=torch.float64, device=device)
    eps = np.asarray(out.orbital_energies)
    e4 = _incore_e4(system, config, device)
    W, eps_o, eps_v, no, _, res = spinorbital_amplitudes(e4, C, C, eps, eps, na, nb, 0, 200,
                                                         cc_epsilon)
    t1, t2, e_corr, iters, converged = res
    if not converged:
        raise RuntimeError("CCSD amplitudes not converged")
    G, E, D = _residual_fns(eps_o, eps_v, no, W)
    return {"out": out, "C": C, "e4": e4, "na": na, "nb": nb, "no": no,
            "nv": eps_v.shape[0], "t": (t1, t2), "G": G, "E": E, "D": D, "e_corr": e_corr,
            "cc_iters": iters, "W": W, "eps_o": eps_o, "eps_v": eps_v}


def _norm(xs) -> float:
    return float(torch.sqrt(sum(torch.sum(x * x) for x in xs)))


def _solve_lambda(ctx, tol: float = 1e-9):
    """lam from J^T lam = -dE/dt by preconditioned GMRES (``vjp`` gives the
    transposed Jacobian's action). Returns (lam tuple, residual norm)."""
    G, E, t = ctx["G"], ctx["E"], ctx["t"]
    D1, D2 = ctx["D"]
    b = tuple(-x for x in grad(lambda ts: E(ts))(t))
    _, vjp_fn = vjp(lambda ts: G(ts), t)

    def A(v):
        return vjp_fn(tuple(v))[0]

    def M(v):
        return (v[0] / (-D1), v[1] / (-D2))

    lam, _ = gmres(A, b, M=M, tol=tol, maxiter=200, restart=40)
    # the true residual decides success, not the solver's flag
    rn = _norm([x - y for x, y in zip(A(lam), b)])
    bn = _norm(b)
    if rn > 1e-6 * max(bn, 1.0):
        raise RuntimeError(f"lambda GMRES residual {rn:.2e} (|b|={bn:.2e})")
    return lam, rn


def _mo_blocks(ctx, V_ao):
    """Spinorbital (Voo, Vov, Vvv) blocks of a one-electron AO operator,
    in the amplitude index convention ([occ_a, occ_b | virt_a, virt_b];
    both spins share the spatial blocks for an RHF reference)."""
    C = ctx["C"]
    na = ctx["na"]
    n = C.shape[1]
    Vmo = (C.T @ torch.as_tensor(V_ao, dtype=C.dtype, device=C.device) @ C).cpu().numpy()
    occ_sp = np.concatenate([np.arange(na), np.arange(na)])
    vir_sp = np.concatenate([np.arange(na, n), np.arange(na, n)])
    # spin-diagonal mask: first half alpha, second half beta
    so = np.array([0] * na + [1] * na)
    sv = np.array([0] * (n - na) + [1] * (n - na))
    Voo = (so[:, None] == so[None, :]) * Vmo[np.ix_(occ_sp, occ_sp)]
    Vov = (so[:, None] == sv[None, :]) * Vmo[np.ix_(occ_sp, vir_sp)]
    Vvv = (sv[:, None] == sv[None, :]) * Vmo[np.ix_(vir_sp, vir_sp)]
    return tuple(torch.as_tensor(x, device=C.device) for x in (Voo, Vov, Vvv))


def _vdot(xs, ys) -> float:
    return float(sum(torch.sum(x * y) for x, y in zip(xs, ys)))


def ccsd_expectation(ctx, lam, V_ao, D_hf) -> float:
    """Unrelaxed CC expectation of a one-electron operator:
    tr(D_HF V) + dE_corr/dtheta + lam . dG/dtheta."""
    f = _mo_blocks(ctx, V_ao)
    G, E, t = ctx["G"], ctx["E"], ctx["t"]
    zeros = tuple(torch.zeros_like(x) for x in f)
    _, dG = jvp(lambda ff: G(t, ff), (zeros,), (f,))
    _, dE = jvp(lambda ff: E(t, ff), (zeros,), (f,))
    corr = float(dE) + _vdot(lam, dG)
    D = torch.as_tensor(np.asarray(D_hf), dtype=torch.float64, device=f[0].device)
    ref = float(torch.sum(D * torch.as_tensor(V_ao, dtype=torch.float64, device=D.device)))
    return ref + corr


def _nuclear_dipole(system) -> np.ndarray:
    pos = np.asarray(system.positions)
    charges = np.array([a.ordinal for a in system.atoms], dtype=float)
    return (charges[:, None] * pos).sum(0)


def _unrelaxed_dipole(system, ctx, lam) -> np.ndarray:
    """Nuclear dipole minus the electronic CC expectation of r (electrons
    carry charge -1)."""
    d_ao = one_electron.dipole_integrals(system, ctx["C"].device)  # (3, n, n), electronic r
    D_hf = ctx["out"].density
    nuc = _nuclear_dipole(system)
    return np.array([nuc[k] - ccsd_expectation(ctx, lam, d_ao[k], D_hf) for k in range(3)])


def ccsd_dipole(
    system: MolecularSystem,
    config: Optional[HartreeFockConfig] = None,
    *,
    cc_epsilon: float = 1e-10,
    device="cuda",
) -> CcPropertyOutput:
    """Unrelaxed CCSD dipole moment (electronic expectation + nuclear),
    with the SCF dipole for comparison. One lambda solve serves all three
    components."""
    config = config or HartreeFockConfig(epsilon=1e-10, max_iterations=200)
    device = check_device(device)
    ctx = _setup(system, config, cc_epsilon, device)
    lam, _ = _solve_lambda(ctx)
    out = ctx["out"]
    return CcPropertyOutput(
        scf_total_energy=out.total_energy(),
        ccsd_total_energy=out.total_energy() + ctx["e_corr"],
        scf_dipole=np.asarray(dipole_moment(system, out.density, device)),
        ccsd_dipole=_unrelaxed_dipole(system, ctx, lam),
        lambda_iterations=ctx["cc_iters"],
    )
