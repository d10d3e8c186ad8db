"""Coupled-cluster singles and doubles, CCSD and CCSD(T), on HF references
(port of ``qchem_rs_tpu/models/cc.py``).

Two formulations of the Stanton-Gauss-Watts-Bartlett amplitude equations
(JCP 94, 4334 (1991)) with canonical orbitals:

- the general spinorbital one (``_spinorbital_setup``, ``_ccsd_step``,
  ``_triples_energy``): closed shells on RHF, open shells on UHF
  (UCCSD(T)); its antisymmetrized tensor W is (2n)^4;
- the closed-shell spin-adapted fast path in spatial orbitals
  (``_mo_phys_blocks`` on the n^4 tensor, or ``_mo_phys_blocks_pair``
  through the pair-space V2f with no n^4 tensor; ``_ccsd_rhf_step``,
  ``_triples_energy_rhf`` and its batched form, a loop over the first
  occupied index with an o^2 v^3 peak).

Every term is a ``torch.einsum``/``matmul`` on ``device`` (the JAX package
computes the same products with XLA einsums, outside any Pallas kernel);
the ERI build under the MO blocks runs kernel 1 and the SCF under them
kernel 2. The steps are pure functions of their tensor arguments (no
in-place writes, no host reads, no branch on a value), so ``torch.func``
can differentiate them: the Lambda, EOM and relaxed-dipole modules take
jvps and vjps through them. The iteration is a host loop with amplitude
DIIS whose history stays on ``device`` (``_AmplitudeDiis``); only the
(k+1)^2 DIIS matrix, the RMS change and the energy go to the host.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from qchem_rs_tpu_torch.config import HartreeFockConfig
from qchem_rs_tpu_torch.models import scf
from qchem_rs_tpu_torch.models.fci import _transform_full
from qchem_rs_tpu_torch.models.mp2 import _n_frozen, _pair_transform_matrix, _pair_v2f
from qchem_rs_tpu_torch.models.rhf import _sync, check_device, restricted_hartree_fock
from qchem_rs_tpu_torch.models.uhf import unrestricted_hartree_fock
from qchem_rs_tpu_torch.ops.eri_tiled import TiledEriEngine
from qchem_rs_tpu_torch.utils.system import MolecularSystem

#: (T) takes the batched form past o^3 v^3 = 2e8 elements (cc.py:820-823)
TRIPLES_FULL_MAX = 2e8


@dataclasses.dataclass
class CcsdOutput:
    scf_total_energy: float
    correlation_energy: float  # CCSD correlation
    mp2_correlation_energy: float  # iteration-0 byproduct (consistency anchor)
    triples_correction: Optional[float]  # (T) energy, when requested
    iterations: int  # CC iterations
    scf_iterations: int
    converged: bool
    # extra beyond the JAX package's output: eri_s (the ERI build and its
    # finish, or V2f), blocks_s (the MO integral blocks), cc_s (the
    # amplitude iterations), triples_s, total_s (all of them; the SCF not
    # included)
    timings: dict = dataclasses.field(default_factory=dict)

    def total_energy(self) -> float:
        e = self.scf_total_energy + self.correlation_energy
        if self.triples_correction is not None:
            e += self.triples_correction
        return e


def _d2(eps_o: torch.Tensor, eps_v: torch.Tensor) -> torch.Tensor:
    return (eps_o[:, None, None, None] + eps_o[None, :, None, None]
            - eps_v[None, None, :, None] - eps_v[None, None, None, :])


# --------------------------------------------------------------------------
# spinorbital integral assembly
# --------------------------------------------------------------------------


def _spinorbital_setup(e4, C_a, C_b, eps_a, eps_b, na, nb, nfz):
    """Antisymmetrized spinorbital MO tensor W[pq|rs] = <pq||rs> (physicist)
    plus the occupied/virtual-ordered orbital energies.

    Ordering: [occ_alpha, occ_beta, virt_alpha, virt_beta] so the o-block
    is a leading slice. Frozen core drops the lowest `nfz` spatial
    occupieds per spin. ``eps_a``/``eps_b`` are host arrays. Returns (W,
    eps_o, eps_v, no, nv); differentiable in C_a and C_b."""
    n = C_a.shape[1]
    dev = e4.device
    g_aa = _transform_full(e4, C_a)
    g_bb = g_aa if C_b is C_a else _transform_full(e4, C_b)
    g_ab = g_aa if C_b is C_a else _transform_full(e4, C_a, C_a, C_b, C_b)

    occ_a, virt_a = np.arange(nfz, na), np.arange(na, n)
    occ_b, virt_b = np.arange(nfz, nb), np.arange(nb, n)
    order_sp = np.concatenate([occ_a, occ_b, virt_a, virt_b])
    order_spin = np.concatenate([np.zeros_like(occ_a), np.ones_like(occ_b),
                                 np.zeros_like(virt_a), np.ones_like(virt_b)])
    eps_a, eps_b = np.asarray(eps_a), np.asarray(eps_b)
    eps_all = np.concatenate([eps_a[occ_a], eps_b[occ_b], eps_a[virt_a], eps_b[virt_b]])
    no = len(occ_a) + len(occ_b)
    nv = len(virt_a) + len(virt_b)
    P = torch.as_tensor(np.arange(n)[None, :] == order_sp[:, None], dtype=e4.dtype, device=dev)

    def chem_so(g, s1, s2):
        """(PQ|RS)_so from a spatial block, masked by spin deltas. The
        spatial indices are picked by products with the one-hot matrix P
        (each moves one axis to the end): their backward is a product too,
        where an index gather's would add into repeated rows with atomics."""
        blk = g
        for _ in range(4):
            blk = torch.tensordot(blk, P, dims=([0], [1]))
        m1 = (order_spin[:, None] == s1) & (order_spin[None, :] == s1)
        m2 = (order_spin[:, None] == s2) & (order_spin[None, :] == s2)
        mask = torch.as_tensor(m1[:, :, None, None] & m2[None, None, :, :], device=dev)
        return blk * mask

    # (PQ|RS)_so = sum over bra/ket spin channels of the matching block
    g_so = (chem_so(g_aa, 0, 0) + chem_so(g_ab, 0, 1)
            + chem_so(g_ab.permute(2, 3, 0, 1), 1, 0) + chem_so(g_bb, 1, 1))
    # physicist antisymmetrized: <pq||rs> = (pr|qs) - (ps|qr)
    W = g_so.permute(0, 2, 1, 3) - g_so.permute(0, 2, 3, 1)
    eps_t = torch.as_tensor(eps_all, dtype=torch.float64, device=dev)
    return W.contiguous(), eps_t[:no], eps_t[no:], no, nv


# --------------------------------------------------------------------------
# CCSD amplitude step (Stanton-Gauss-Watts-Bartlett, canonical orbitals)
# --------------------------------------------------------------------------


def _p_ij(x):
    return x - x.transpose(0, 1)


def _p_ab(x):
    return x - x.transpose(2, 3)


ein = torch.einsum


def _ccsd_step(t1, t2, eps_o, eps_v, no, W, f=None):
    """One CCSD update: (t1, t2) -> (t1', t2', E_corr').

    ``f`` (optional) = (foo, fov, fvv): a general one-electron MO operator
    added on top of the canonical diagonal — the SGWB equations keep eps in
    the denominators and carry the rest linearly through the F
    intermediates, which is exact for any split f = diag(eps) + R. The
    Lambda, EOM and relaxed-dipole modules differentiate through it."""
    o, v = slice(0, no), slice(no, None)
    Woooo = W[o, o, o, o]
    Wooov = W[o, o, o, v]
    Woovo = W[o, o, v, o]
    Woovv = W[o, o, v, v]
    Wovov = W[o, v, o, v]
    Wovvo = W[o, v, v, o]
    Wovoo = W[o, v, o, o]
    Wovvv = W[o, v, v, v]
    Wvovv = W[v, o, v, v]
    Wvvvo = W[v, v, v, o]
    Wvvvv = W[v, v, v, v]

    D1 = eps_o[:, None] - eps_v[None, :]
    D2 = _d2(eps_o, eps_v)

    t1t1 = ein("ia,jb->ijab", t1, t1)
    t1t1 = t1t1 - t1t1.transpose(2, 3)
    tau_t = t2 + 0.5 * t1t1
    tau = t2 + t1t1

    Fae = ein("mf,mafe->ae", t1, Wovvv) - 0.5 * ein("mnaf,mnef->ae", tau_t, Woovv)
    Fmi = ein("ne,mnie->mi", t1, Wooov) + 0.5 * ein("inef,mnef->mi", tau_t, Woovv)
    Fme = ein("nf,mnef->me", t1, Woovv)
    if f is not None:
        foo, fov, fvv = f
        Fae = Fae + fvv - 0.5 * ein("ma,me->ae", t1, fov)
        Fmi = Fmi + foo + 0.5 * ein("ie,me->mi", t1, fov)
        Fme = Fme + fov

    Wmnij = (Woooo + _p_ab(ein("je,mnie->mnij", t1, Wooov))
             + 0.25 * ein("ijef,mnef->mnij", tau, Woovv))
    Wabef = (Wvvvv - _p_ij(ein("mb,amef->abef", t1, Wvovv))
             + 0.25 * ein("mnab,mnef->abef", tau, Woovv))
    Wmbej = (Wovvo + ein("jf,mbef->mbej", t1, Wovvv) - ein("nb,mnej->mbej", t1, Woovo)
             - ein("jnfb,mnef->mbej", 0.5 * t2 + ein("jf,nb->jnfb", t1, t1), Woovv))

    # ---- T1 ----------------------------------------------------------------
    rhs1 = (ein("ie,ae->ia", t1, Fae) - ein("ma,mi->ia", t1, Fmi)
            + ein("imae,me->ia", t2, Fme) - ein("nf,naif->ia", t1, Wovov)
            - 0.5 * ein("imef,maef->ia", t2, Wovvv) - 0.5 * ein("mnae,nmei->ia", t2, Woovo))
    if f is not None:
        rhs1 = rhs1 + fov
    t1_new = rhs1 / D1

    # ---- T2 ----------------------------------------------------------------
    Xbe = Fae - 0.5 * ein("mb,me->be", t1, Fme)
    Xmj = Fmi + 0.5 * ein("je,me->mj", t1, Fme)
    rhs2 = Woovv
    rhs2 = rhs2 + _p_ab(ein("ijae,be->ijab", t2, Xbe))
    rhs2 = rhs2 - _p_ij(ein("imab,mj->ijab", t2, Xmj))
    rhs2 = rhs2 + 0.5 * ein("mnab,mnij->ijab", tau, Wmnij)
    rhs2 = rhs2 + 0.5 * ein("ijef,abef->ijab", tau, Wabef)
    ring = (ein("imae,mbej->ijab", t2, Wmbej)
            - ein("ma,imbj->ijab", t1, ein("ie,mbej->imbj", t1, Wovvo)))
    rhs2 = rhs2 + _p_ij(_p_ab(ring))
    rhs2 = rhs2 + _p_ij(ein("ie,abej->ijab", t1, Wvvvo))
    rhs2 = rhs2 - _p_ab(ein("ma,mbij->ijab", t1, Wovoo))
    t2_new = rhs2 / D2

    energy = (0.25 * ein("ijab,ijab->", Woovv, t2_new)
              + 0.5 * ein("ijab,ia,jb->", Woovv, t1_new, t1_new))
    if f is not None:
        energy = energy + ein("ia,ia->", fov, t1_new)
    return t1_new, t2_new, energy


def _d3(eps_o, eps_v):
    return (eps_o[:, None, None, None, None, None] + eps_o[None, :, None, None, None, None]
            + eps_o[None, None, :, None, None, None] - eps_v[None, None, None, :, None, None]
            - eps_v[None, None, None, None, :, None] - eps_v[None, None, None, None, None, :])


def _p_i_jk(x):  # P(i/jk) over axes (0,1,2)
    return x - x.transpose(0, 1) - x.transpose(0, 2)


def _p_a_bc(x):  # P(a/bc) over axes (3,4,5)
    return x - x.transpose(3, 4) - x.transpose(3, 5)


def _triples_energy(t1, t2, eps_o, eps_v, no, W):
    """Conventional (T): disconnected + connected triples, full-tensor form
    (o^3 v^3 memory)."""
    o, v = slice(0, no), slice(no, None)
    Woovv = W[o, o, v, v]
    Wvovv = W[v, o, v, v]
    Wovoo = W[o, v, o, o]
    num_d = _p_i_jk(_p_a_bc(ein("ia,jkbc->ijkabc", t1, Woovv)))
    num_c = _p_i_jk(_p_a_bc(ein("jkae,eibc->ijkabc", t2, Wvovv)
                            - ein("imbc,majk->ijkabc", t2, Wovoo)))
    return (1.0 / 36.0) * ein("ijkabc,ijkabc->", num_c, (num_c + num_d) / _d3(eps_o, eps_v))


# --------------------------------------------------------------------------
# closed-shell spin-adapted fast path (spatial orbitals)
# --------------------------------------------------------------------------
#
# The spin summation of the SGWB equations onto the mixed (alpha-beta)
# amplitude block T[i,j,a,b] = t2[ia_alpha, jb_beta]; the same-spin blocks
# are A = T - T.swap(a,b). The tests hold it against the spinorbital step.


def _mo_phys_blocks(e4, Co, Cv):
    """Physicist-notation <pq|rs> MO blocks from the AO chemist tensor:
    the six chemist blocks by quarter-transforms (each a batched matrix
    product; one n^4-scale buffer at a time), then ``_phys_from_chem``."""
    n, no, nv = e4.shape[0], Co.shape[1], Cv.shape[1]
    A1 = (Co.T @ e4.reshape(n, n**3)).reshape(no, n, n * n)  # [i, q, (r s)]
    oo = torch.matmul(Co.T, A1).reshape(no * no, n, n)  # [(i j), r, s]
    ov = torch.matmul(Cv.T, A1).reshape(no * nv, n, n)  # [(i a), r, s]
    del A1

    def half(x, L, R, *shape):
        return (torch.matmul(L.T, x) @ R).reshape(*shape)

    c_oooo = half(oo, Co, Co, no, no, no, no)
    c_ooov = half(oo, Co, Cv, no, no, no, nv)
    c_oovv = half(oo, Cv, Cv, no, no, nv, nv)
    del oo
    c_ovov = half(ov, Co, Cv, no, nv, no, nv)
    c_ovvv = half(ov, Cv, Cv, no, nv, nv, nv)
    del ov
    B1 = (Cv.T @ e4.reshape(n, n**3)).reshape(nv, n, n * n)
    vv = torch.matmul(Cv.T, B1).reshape(nv * nv, n, n)
    del B1
    c_vvvv = half(vv, Cv, Cv, nv, nv, nv, nv)
    del vv
    return _phys_from_chem(c_oooo, c_ooov, c_oovv, c_ovov, c_ovvv, c_vvvv)


def _pair_contract(V2f, L, R):
    return L.T @ (V2f @ R)


def _mo_phys_blocks_pair(builder, V2f, Co, Cv):
    """The same six chemist MO blocks through the mirrored pair-space V2f
    of ``builder``: U_L^T V2f U_R, two matrix products each, no n^4 AO
    tensor (the nv^4 vvvv block is the memory cap)."""
    no, nv = Co.shape[1], Cv.shape[1]
    U_oo = _pair_transform_matrix(builder, Co, Co)
    U_ov = _pair_transform_matrix(builder, Co, Cv)
    U_vv = _pair_transform_matrix(builder, Cv, Cv)
    c_oooo = _pair_contract(V2f, U_oo, U_oo).reshape(no, no, no, no)
    c_ooov = _pair_contract(V2f, U_oo, U_ov).reshape(no, no, no, nv)
    c_oovv = _pair_contract(V2f, U_oo, U_vv).reshape(no, no, nv, nv)
    c_ovov = _pair_contract(V2f, U_ov, U_ov).reshape(no, nv, no, nv)
    c_ovvv = _pair_contract(V2f, U_ov, U_vv).reshape(no, nv, nv, nv)
    c_vvvv = _pair_contract(V2f, U_vv, U_vv).reshape(nv, nv, nv, nv)
    return _phys_from_chem(c_oooo, c_ooov, c_oovv, c_ovov, c_ovvv, c_vvvv)


def _phys_from_chem(c_oooo, c_ooov, c_oovv, c_ovov, c_ovvv, c_vvvv):
    """Chemist -> physicist relabelings (<pq|rs> = (pr|qs)), each made
    contiguous once, so that the amplitude steps read them in place."""
    blocks = {
        "oooo": ein("ikjl->ijkl", c_oooo),
        "ooov": ein("ikja->ijka", c_ooov),
        "oovo": ein("jkia->ijak", c_ooov),
        "ovoo": ein("ijka->iajk", c_ooov),
        "oovv": ein("iajb->ijab", c_ovov),
        "ovov": ein("ijab->iajb", c_oovv),
        "ovvo": ein("ibja->iabj", c_ovov),
        "ovvv": ein("ibac->iabc", c_ovvv),
        "vovv": ein("icab->aibc", c_ovvv),
        "vvvo": ein("ibac->abci", c_ovvv),
        "vvvv": ein("acbd->abcd", c_vvvv),
    }
    return {k: x.contiguous() for k, x in blocks.items()}


def _ccsd_rhf_step(t1, T, eps_o, eps_v, g):
    """One closed-shell CCSD update on (t1, T). ``g`` is the physicist
    block dict from ``_mo_phys_blocks``."""
    g_oovv, g_ovvv, g_ooov = g["oovv"], g["ovvv"], g["ooov"]
    g_oovo, g_ovov, g_ovvo = g["oovo"], g["ovov"], g["ovvo"]
    g_oooo, g_vvvv, g_vovv = g["oooo"], g["vvvv"], g["vovv"]
    g_vvvo, g_ovoo = g["vvvo"], g["ovoo"]

    L_oovv = 2.0 * g_oovv - g_oovv.transpose(2, 3)
    L_ovvv = 2.0 * g_ovvv - g_ovvv.transpose(2, 3)
    L_ooov = 2.0 * g_ooov - g_oovo.permute(0, 1, 3, 2)

    D1 = eps_o[:, None] - eps_v[None, :]
    D2 = _d2(eps_o, eps_v)

    t1t1 = ein("ia,jb->ijab", t1, t1)
    tau = T + t1t1
    ttau = T + 0.5 * t1t1
    A = T - T.transpose(2, 3)
    u = 2.0 * T - T.transpose(2, 3)
    g_ovov_x = g_ovov.permute(0, 1, 3, 2)  # mbje -> mbej

    Fae = ein("mf,mafe->ae", t1, L_ovvv) - ein("mnaf,mnef->ae", ttau, L_oovv)
    Fmi = ein("ne,mnie->mi", t1, L_ooov) + ein("inef,mnef->mi", ttau, L_oovv)
    Fme = ein("nf,mnef->me", t1, L_oovv)

    rhs1 = (ein("ie,ae->ia", t1, Fae) - ein("ma,mi->ia", t1, Fmi)
            + ein("imae,me->ia", u, Fme) - ein("nf,naif->ia", t1, g_ovov)
            + ein("nf,nafi->ia", t1, 2.0 * g_ovvo) + ein("imef,mafe->ia", T, 2.0 * g_ovvv)
            - ein("imef,maef->ia", T, g_ovvv) - ein("mnae,nmei->ia", T, 2.0 * g_oovo)
            + ein("mnae,nmie->ia", T, g_ooov))
    t1n = rhs1 / D1

    Wmnij = (g_oooo + ein("je,mnie->mnij", t1, g_ooov) + ein("ie,mnej->mnij", t1, g_oovo)
             + 0.5 * ein("ijef,mnef->mnij", tau, g_oovv))
    Wabef = (g_vvvv - ein("mb,amef->abef", t1, g_vovv) - ein("ma,bmfe->abef", t1, g_vovv)
             + 0.5 * ein("mnab,mnef->abef", tau, g_oovv))
    t1g_oovv = ein("nb,mnef->mbef", t1, g_oovv)  # the jf,nb,mn.. terms, one product at a time
    t1g_oovv_x = t1g_oovv.transpose(2, 3)  # nb,mnfe
    Wx = (g_ovvo + ein("jf,mbef->mbej", t1, g_ovvv) - ein("nb,mnej->mbej", t1, g_oovo)
          - ein("jf,mbef->mbej", t1, t1g_oovv)
          + 0.5 * ein("jnbf,mnef->mbej", u, g_oovv) - 0.5 * ein("jnbf,mnfe->mbej", T, g_oovv))
    Ws = (g_ovvo - g_ovov_x + ein("jf,mbef->mbej", t1, g_ovvv)
          - ein("jf,mbfe->mbej", t1, g_ovvv) - ein("nb,mnej->mbej", t1, g_oovo)
          + ein("nb,mnje->mbej", t1, g_ooov) - 0.5 * ein("jnfb,mnef->mbej", A, g_oovv)
          + 0.5 * ein("jnfb,mnfe->mbej", A, g_oovv) - ein("jf,mbef->mbej", t1, t1g_oovv)
          + ein("jf,mbef->mbej", t1, t1g_oovv_x) + 0.5 * ein("jnbf,mnef->mbej", T, g_oovv))
    Wy = (-g_ovov_x - ein("jf,mbfe->mbej", t1, g_ovvv) + ein("nb,mnje->mbej", t1, g_ooov)
          + 0.5 * ein("njbf,mnfe->mbej", T, g_oovv) + ein("jf,mbef->mbej", t1, t1g_oovv_x))

    Xbe = Fae - 0.5 * ein("mb,me->be", t1, Fme)
    Xmj = Fmi + 0.5 * ein("je,me->mj", t1, Fme)

    Z = ein("ijae,be->ijab", T, Xbe)
    Z = Z - ein("imab,mj->ijab", T, Xmj)
    Z = Z + ein("ie,abej->ijab", t1, g_vvvo)
    Z = Z - ein("ma,mbij->ijab", t1, g_ovoo)
    Z = Z + ein("imae,mbej->ijab", A, Wx)
    Z = Z + ein("imae,mbej->ijab", T, Ws)
    Z = Z + ein("imeb,maej->ijab", T, Wy)
    Z = Z - ein("ma,imbj->ijab", t1, ein("ie,mbej->imbj", t1, g_ovvo))
    Z = Z - ein("mb,imaj->ijab", t1, ein("ie,maje->imaj", t1, g_ovov))

    rhs2 = g_oovv + Z + Z.permute(1, 0, 3, 2)
    rhs2 = rhs2 + ein("mnab,mnij->ijab", tau, Wmnij)
    rhs2 = rhs2 + ein("ijef,abef->ijab", tau, Wabef)
    Tn = rhs2 / D2

    energy = ein("ijab,ijab->", L_oovv, Tn + ein("ia,jb->ijab", t1n, t1n))
    return t1n, Tn, energy


def _triples_blocks(T, g):
    A = T - T.transpose(2, 3)
    gb = {k: g[k] - g[k].transpose(2, 3) for k in ("oovv", "vovv", "ovoo")}
    return A, gb


def _triples_energy_rhf(t1, T, eps_o, eps_v, g):
    """Closed-shell (T) in spatial orbitals: E_T = (1/18) S_aaa + (1/2) S_aab,
    the all-alpha and two-alpha/one-beta blocks of the spinorbital formula;
    full o^3 v^3 tensors."""
    g_oovv, g_vovv, g_ovoo = g["oovv"], g["vovv"], g["ovoo"]
    A, gb = _triples_blocks(T, g)
    gb_oovv, gb_vovv, gb_ovoo = gb["oovv"], gb["vovv"], gb["ovoo"]
    D3 = _d3(eps_o, eps_v)

    numd_aaa = _p_i_jk(_p_a_bc(ein("ia,jkbc->ijkabc", t1, gb_oovv)))
    numc_aaa = _p_i_jk(_p_a_bc(ein("jkae,eibc->ijkabc", A, gb_vovv)
                               - ein("imbc,majk->ijkabc", A, gb_ovoo)))
    s_aaa = ein("ijkabc,ijkabc->", numc_aaa, (numc_aaa + numd_aaa) / D3)

    numd = (ein("ia,jkbc->ijkabc", t1, g_oovv) - ein("ib,jkac->ijkabc", t1, g_oovv)
            - ein("ja,ikbc->ijkabc", t1, g_oovv) + ein("jb,ikac->ijkabc", t1, g_oovv)
            + ein("kc,jiba->ijkabc", t1, gb_oovv))
    numc = (-ein("jkae,eicb->ijkabc", T, g_vovv) + ein("jkbe,eica->ijkabc", T, g_vovv)
            + ein("jkec,eiba->ijkabc", T, gb_vovv) + ein("ikae,ejcb->ijkabc", T, g_vovv)
            - ein("ikbe,ejca->ijkabc", T, g_vovv) - ein("ikec,ejba->ijkabc", T, gb_vovv)
            - ein("jiae,ekbc->ijkabc", A, g_vovv) + ein("jibe,ekac->ijkabc", A, g_vovv)
            + ein("imbc,makj->ijkabc", T, g_ovoo) - ein("imac,mbkj->ijkabc", T, g_ovoo)
            + ein("imba,mcjk->ijkabc", A, g_ovoo) - ein("jmbc,maki->ijkabc", T, g_ovoo)
            + ein("jmac,mbki->ijkabc", T, g_ovoo) - ein("jmba,mcik->ijkabc", A, g_ovoo)
            - ein("mkbc,maji->ijkabc", T, gb_ovoo) + ein("mkac,mbji->ijkabc", T, gb_ovoo))
    s_aab = ein("ijkabc,ijkabc->", numc, (numc + numd) / D3)
    return s_aaa / 18.0 + 0.5 * s_aab


def _p_abc5(x):
    return x - x.transpose(2, 3) - x.transpose(2, 4)


@torch.no_grad()
def _triples_energy_rhf_batched(t1, T, eps_o, eps_v, g):
    """The same closed-shell (T) as ``_triples_energy_rhf``, as a loop over
    the first occupied index i: each pass builds [j k a b c] slabs, so the
    peak is o^2 v^3 rather than o^3 v^3. The slab sums accumulate in place
    (no autograd runs here)."""
    g_oovv, g_vovv, g_ovoo = g["oovv"], g["vovv"], g["ovoo"]
    A, gb = _triples_blocks(T, g)
    gb_oovv, gb_vovv, gb_ovoo = gb["oovv"], gb["vovv"], gb["ovoo"]
    no = eps_o.shape[0]
    D3_jk = (eps_o[:, None, None, None, None] + eps_o[None, :, None, None, None]
             - eps_v[None, None, :, None, None] - eps_v[None, None, None, :, None]
             - eps_v[None, None, None, None, :])
    total = torch.zeros((), dtype=T.dtype, device=T.device)
    for i in range(no):
        t1_i, Ti, Ai = t1[i], T[i], A[i]

        # ---- all-alpha block at fixed i -----------------------------------
        numd = ein("a,jkbc->jkabc", t1_i, gb_oovv)
        numd -= ein("ja,kbc->jkabc", t1, gb_oovv[i])
        numd -= ein("ka,jbc->jkabc", t1, gb_oovv[:, i])
        numd = _p_abc5(numd)
        numc = ein("jkae,ebc->jkabc", A, gb_vovv[:, i])
        numc -= ein("mbc,majk->jkabc", Ai, gb_ovoo)
        numc -= ein("kae,ejbc->jkabc", Ai, gb_vovv)
        numc += ein("jmbc,mak->jkabc", A, gb_ovoo[:, :, i])
        numc -= ein("jae,ekbc->jkabc", A[:, i], gb_vovv)
        numc += ein("kmbc,maj->jkabc", A, gb_ovoo[..., i])
        numc = _p_abc5(numc)
        numd += numc
        numd /= eps_o[i] + D3_jk
        s_aaa = torch.sum(numc * numd)
        del numc, numd

        # ---- mixed block at fixed i ---------------------------------------
        numd = ein("a,jkbc->jkabc", t1_i, g_oovv)
        numd -= ein("b,jkac->jkabc", t1_i, g_oovv)
        numd -= ein("ja,kbc->jkabc", t1, g_oovv[i])
        numd += ein("jb,kac->jkabc", t1, g_oovv[i])
        numd += ein("kc,jba->jkabc", t1, gb_oovv[:, i])
        numc = -ein("jkae,ecb->jkabc", T, g_vovv[:, i])
        numc += ein("jkbe,eca->jkabc", T, g_vovv[:, i])
        numc += ein("jkec,eba->jkabc", T, gb_vovv[:, i])
        numc += ein("kae,ejcb->jkabc", Ti, g_vovv)
        numc -= ein("kbe,ejca->jkabc", Ti, g_vovv)
        numc -= ein("kec,ejba->jkabc", Ti, gb_vovv)
        numc -= ein("jae,ekbc->jkabc", A[:, i], g_vovv)
        numc += ein("jbe,ekac->jkabc", A[:, i], g_vovv)
        numc += ein("mbc,makj->jkabc", Ti, g_ovoo)
        numc -= ein("mac,mbkj->jkabc", Ti, g_ovoo)
        numc += ein("mba,mcjk->jkabc", Ai, g_ovoo)
        numc -= ein("jmbc,mak->jkabc", T, g_ovoo[..., i])
        numc += ein("jmac,mbk->jkabc", T, g_ovoo[..., i])
        numc -= ein("jmba,mck->jkabc", A, g_ovoo[:, :, i])
        numc -= ein("mkbc,maj->jkabc", T, gb_ovoo[..., i])
        numc += ein("mkac,mbj->jkabc", T, gb_ovoo[..., i])
        numd += numc
        numd /= eps_o[i] + D3_jk
        s_aab = torch.sum(numc * numd)
        del numc, numd
        total = total + s_aaa / 18.0 + 0.5 * s_aab
    return total


# --------------------------------------------------------------------------
# amplitude DIIS, its history on the amplitudes' device
# --------------------------------------------------------------------------


class _AmplitudeDiis:
    def __init__(self, max_vectors: int = 8):
        self.max = max_vectors
        self.amps: list[torch.Tensor] = []
        self.errs: list[torch.Tensor] = []
        self._B = np.empty((0, 0))  # the error overlaps, kept on the host

    def extrapolate(self, amp: torch.Tensor, err: torch.Tensor) -> torch.Tensor:
        """The DIIS mix of the stored amplitudes. Each new error vector's
        overlaps with the history are ``torch.dot`` products on the device;
        only they go to the host, where the (k+1)^2 system is solved."""
        self.amps.append(amp)
        self.errs.append(err)
        new = torch.stack([torch.dot(e, err) for e in self.errs]).cpu().numpy()
        k = len(self.errs)
        B = np.empty((k, k))
        B[: k - 1, : k - 1] = self._B
        B[k - 1, :] = B[:, k - 1] = new
        self._B = B
        if k > self.max:
            self.amps.pop(0)
            self.errs.pop(0)
            self._B = self._B[1:, 1:]
            k -= 1
        if k < 2:
            return amp
        Bx = np.empty((k + 1, k + 1))
        Bx[:k, :k] = self._B
        Bx[k, :], Bx[:, k], Bx[k, k] = -1.0, -1.0, 0.0
        rhs = np.zeros(k + 1)
        rhs[k] = -1.0
        try:
            c = np.linalg.solve(Bx, rhs)[:k]
        except np.linalg.LinAlgError:
            return amp
        out = torch.zeros_like(amp)
        for ci, ai in zip(c, self.amps):
            out.add_(ai, alpha=float(ci))
        return out


# --------------------------------------------------------------------------
# the CCSD entry point
# --------------------------------------------------------------------------


def _cc_loop(step, t1, t2, e_start, max_iterations, epsilon):
    """Host-driven amplitude iteration with DIIS; shape-agnostic (serves the
    spinorbital and spatial formulations). The amplitudes and the DIIS
    history stay on their device; each pass reads the RMS change and the
    energy on the host. Returns (t1, t2, energy, iterations, converged)."""
    diis = _AmplitudeDiis()
    n1 = t1.numel()
    shape1, shape2 = t1.shape, t2.shape
    energy = e_start
    converged = False
    iterations = 0
    with torch.no_grad():
        for it in range(1, max_iterations + 1):
            t1_new, t2_new, e_new = step(t1, t2)
            flat_new = torch.cat([t1_new.reshape(-1), t2_new.reshape(-1)])
            err = flat_new - torch.cat([t1.reshape(-1), t2.reshape(-1)])
            rms, e_val = torch.stack([torch.sqrt(torch.mean(err**2)), e_new]).cpu().tolist()
            de = e_val - energy
            energy = e_val
            iterations = it
            if rms < epsilon and abs(de) < epsilon:
                t1, t2 = t1_new, t2_new
                converged = True
                break
            mixed = diis.extrapolate(flat_new, err)
            t1 = mixed[:n1].reshape(shape1)
            t2 = mixed[n1:].reshape(shape2)
    return t1, t2, energy, iterations, converged


def _reference(system, config, output, device):
    """(SCF output, (na, nb)) of a CC run: ``output`` when given, else RHF
    for a closed shell and UHF otherwise, on ``device``."""
    na, nb = scf.electron_counts(system.n_electrons(config.charge), config.spin_multiplicity)
    if output is not None:
        out = output
    elif na == nb:
        out = restricted_hartree_fock(system, config, device=device)
    else:
        out = unrestricted_hartree_fock(system, config, device=device)
    if not out.converged:
        raise RuntimeError("SCF not converged; CCSD would be meaningless")
    return out, na, nb


def _incore_e4(system, config, device) -> torch.Tensor:
    """The in-core (n, n, n, n) tensor of the working basis (kernel 1)."""
    engine = TiledEriEngine(system, config.screening_threshold, device=device)
    return engine.finish_eri(engine.build())


def _spinorbital_loop(W, eps_o, eps_v, no, max_iterations, epsilon):
    """Spinorbital CCSD from the MP2 start (t1 = 0, t2 = <ij||ab> / D2).
    Returns (e_mp2, (t1, t2, energy, iterations, converged))."""
    Woovv = W[:no, :no, no:, no:]
    t1 = torch.zeros((no, eps_v.shape[0]), dtype=W.dtype, device=W.device)
    t2 = Woovv / _d2(eps_o, eps_v)
    e_mp2 = float(0.25 * ein("ijab,ijab->", Woovv, t2))
    return e_mp2, _cc_loop(lambda a, b: _ccsd_step(a, b, eps_o, eps_v, no, W), t1, t2, e_mp2,
                           max_iterations, epsilon)


def spinorbital_amplitudes(e4, C_a, C_b, eps_a, eps_b, na, nb, nfz, max_iterations, epsilon):
    """Spinorbital CCSD on the orbitals C_a, C_b. Returns (W, eps_o, eps_v,
    no, e_mp2, (t1, t2, energy, iterations, converged))."""
    W, eps_o, eps_v, no, _ = _spinorbital_setup(e4, C_a, C_b, eps_a, eps_b, na, nb, nfz)
    e_mp2, res = _spinorbital_loop(W, eps_o, eps_v, no, max_iterations, epsilon)
    return W, eps_o, eps_v, no, e_mp2, res


def spatial_amplitudes(g, eps_o, eps_v, max_iterations, epsilon):
    """Closed-shell CCSD from the MP2 start on the physicist blocks ``g``.
    Returns (e_mp2, (t1, T, energy, iterations, converged))."""
    g_oovv = g["oovv"]
    L_oovv = 2.0 * g_oovv - g_oovv.transpose(2, 3)
    T = g_oovv / _d2(eps_o, eps_v)
    t1 = torch.zeros((eps_o.shape[0], eps_v.shape[0]), dtype=T.dtype, device=T.device)
    e_mp2 = float(ein("ijab,ijab->", L_oovv, T))
    res = _cc_loop(lambda a, b: _ccsd_rhf_step(a, b, eps_o, eps_v, g), t1, T, e_mp2,
                   max_iterations, epsilon)
    return e_mp2, res


def ccsd(
    system: MolecularSystem,
    config: Optional[HartreeFockConfig] = None,
    *,
    frozen: int | str = 0,
    triples: bool = False,
    max_cc_iterations: int = 100,
    cc_epsilon: float = 1e-8,
    formulation: str = "auto",
    output=None,
    builder=None,
    device="cuda",
) -> CcsdOutput:
    """CCSD (optionally with perturbative triples) on an HF reference.

    Closed shells run on RHF orbitals, open shells (spin_multiplicity > 1)
    on UHF. ``formulation``: "spatial" is the closed-shell spin-adapted
    fast path; "spinorbital" the general path; "auto" picks spatial for
    restricted references. ``cc_epsilon`` bounds both the amplitude RMS
    change and |dE| between iterations. ``config.fock_mode == "pair"``
    takes the spatial MO blocks through the pair-space V2f (of ``builder``
    when it has one prepared, else built and mirrored once); every other
    mode, and the spinorbital path, uses the in-core n^4 tensor."""
    config = config or HartreeFockConfig(epsilon=1e-10, max_iterations=200)
    device = check_device(device)
    if formulation not in ("auto", "spatial", "spinorbital"):
        raise ValueError(f"unknown formulation={formulation!r}")
    out, na, nb = _reference(system, config, output, device)

    if hasattr(out, "orbital_energies_alpha"):  # UHF output
        C = torch.as_tensor(out.coefficients, dtype=torch.float64, device=device)
        C_a, C_b = C[0], C[1]
        eps_a, eps_b = np.asarray(out.orbital_energies_alpha), np.asarray(out.orbital_energies_beta)
    else:
        C_a = C_b = torch.as_tensor(out.coefficients, dtype=torch.float64, device=device)
        eps_a = eps_b = np.asarray(out.orbital_energies)

    nfz = _n_frozen(system, frozen)
    if nfz >= min(na, nb):
        raise ValueError(f"frozen={nfz} leaves no correlated occupied orbitals")
    if formulation == "spatial" and na != nb:
        raise ValueError("formulation='spatial' requires a closed shell")
    # auto: spatial only on a genuinely restricted reference (UHF outputs on
    # closed shells keep the spinorbital path)
    use_spatial = formulation == "spatial" or (formulation == "auto" and na == nb and C_b is C_a)

    t0 = time.perf_counter()
    e_t = None
    if use_spatial:
        if config.fock_mode == "pair":
            Cx = C_a
            if system.spherical:
                Cx = torch.as_tensor(system.sph_T, dtype=C_a.dtype, device=device) @ C_a
            V2f, builder = _pair_v2f(system, config, device, builder)
            _sync(device)
            t1_ = time.perf_counter()
            g = _mo_phys_blocks_pair(builder, V2f, Cx[:, nfz:na], Cx[:, na:])
            del V2f
        else:
            e4 = _incore_e4(system, config, device)
            _sync(device)
            t1_ = time.perf_counter()
            g = _mo_phys_blocks(e4, C_a[:, nfz:na], C_a[:, na:])
            del e4
        _sync(device)
        t2_ = time.perf_counter()
        eps_o = torch.as_tensor(eps_a[nfz:na], dtype=torch.float64, device=device)
        eps_v = torch.as_tensor(eps_a[na:], dtype=torch.float64, device=device)
        e_mp2, (t1, T, energy, iterations, converged) = spatial_amplitudes(
            g, eps_o, eps_v, max_cc_iterations, cc_epsilon)
        _sync(device)
        t3_ = time.perf_counter()
        if triples:
            # full 6-index tensors up to 2e8 elements; the batched form beyond
            o3v3 = eps_o.numel() ** 3 * eps_v.numel() ** 3
            tri = _triples_energy_rhf_batched if o3v3 > TRIPLES_FULL_MAX else _triples_energy_rhf
            with torch.no_grad():
                e_t = float(tri(t1, T, eps_o, eps_v, g))
    else:
        e4 = _incore_e4(system, config, device)
        _sync(device)
        t1_ = time.perf_counter()
        W, eps_o, eps_v, no, _ = _spinorbital_setup(e4, C_a, C_b, eps_a, eps_b, na, nb, nfz)
        del e4
        _sync(device)
        t2_ = time.perf_counter()
        e_mp2, (t1, t2, energy, iterations, converged) = _spinorbital_loop(
            W, eps_o, eps_v, no, max_cc_iterations, cc_epsilon)
        _sync(device)
        t3_ = time.perf_counter()
        if triples:
            with torch.no_grad():
                e_t = float(_triples_energy(t1, t2, eps_o, eps_v, no, W))
    t4_ = time.perf_counter()
    timings = {"eri_s": t1_ - t0, "blocks_s": t2_ - t1_, "cc_s": t3_ - t2_,
               "triples_s": t4_ - t3_, "total_s": t4_ - t0}
    return CcsdOutput(
        scf_total_energy=out.total_energy(),
        correlation_energy=energy,
        mp2_correlation_energy=e_mp2,
        triples_correction=e_t,
        iterations=iterations,
        scf_iterations=out.iterations,
        converged=converged,
        timings=timings,
    )
