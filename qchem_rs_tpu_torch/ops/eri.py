"""Shell-pair machinery for the two-electron integrals (port of
``qchem_rs_tpu/ops/eri.py:42-207``).

Chemists' notation (ij|kl) throughout. Shell pairs are precomputed per
(la, lb) class, la >= lb, into dense **Hermite charge distributions**
``E[pair, prim, compAB, tuv]`` (contraction coefficients and Cartesian
normalization folded in). A quartet then only needs

    R2[n, a, c, s1, s2] = pref * (-1)^{|s2|} * R_{s1+s2}(alpha, P - Q)
    (ij|kl)[n, A, C]    = E_bra[n,a,A,s1] . R2[n,a,c,s1,s2] . E_ket[n,c,C,s2]
"""

from __future__ import annotations

import dataclasses
import math
from functools import lru_cache

import numpy as np
import torch

from qchem_rs_tpu_torch.ops.angular import component_norms
from qchem_rs_tpu_torch.ops.mcmurchie import (
    hermite_components,
    hermite_expansion_dense,
    hermite_index,
    nhermite,
    r_table_leading,
)
from qchem_rs_tpu_torch.utils.system import MolecularSystem


@dataclasses.dataclass
class PairGroup:
    """All unique shell pairs of one (la, lb) class, la >= lb, as batched
    tensors. Hermite charge distributions have contraction coefficients and
    per-component norms folded in."""

    la: int
    lb: int
    i_shell: np.ndarray  # (n,) global shell index (class la member)
    j_shell: np.ndarray  # (n,)
    ao_i: np.ndarray  # (n,) AO offset of shell i
    ao_j: np.ndarray  # (n,)
    p: torch.Tensor  # (n, Kab) combined exponents, prim axes merged
    P: torch.Tensor  # (n, Kab, 3) gaussian product centers
    E: torch.Tensor  # (n, Kab, ncompAB, nhermite(la+lb))

    @property
    def npairs(self) -> int:
        return len(self.ao_i)

    @property
    def L(self) -> int:
        return self.la + self.lb

    def take(self, order: np.ndarray) -> "PairGroup":
        """The same group with its pairs permuted by ``order``."""
        o = torch.as_tensor(order, device=self.p.device)
        return dataclasses.replace(
            self,
            i_shell=self.i_shell[order], j_shell=self.j_shell[order],
            ao_i=self.ao_i[order], ao_j=self.ao_j[order],
            p=self.p[o], P=self.P[o], E=self.E[o],
        )


def _pair_hermite(la, lb, a, b, cc, A, B, AB):
    """E (n, Ka*Kb, ncompAB, S), p (n, Ka*Kb), P (n, Ka*Kb, 3)."""
    p = a + b  # (n, Ka, Kb)
    P = (a[..., None] * A[:, None, None, :] + b[..., None] * B[:, None, None, :]) / p[..., None]
    E = hermite_expansion_dense(la, lb, a, b, AB)  # (n, Ka, Kb, Acomp, S)
    E = E * cc[..., None, None]
    norms = np.kron(component_norms(la), component_norms(lb))
    E = E * torch.as_tensor(norms, dtype=E.dtype, device=E.device)[None, None, None, :, None]
    n, Ka, Kb = p.shape
    return (
        E.reshape(n, Ka * Kb, E.shape[3], E.shape[4]),
        p.reshape(n, Ka * Kb),
        P.reshape(n, Ka * Kb, 3),
    )


def build_pair_groups(system: MolecularSystem, device) -> list[PairGroup]:
    """Unique shell pairs {i, j} grouped by unordered class pair (la >= lb),
    classes in ascending la, then ascending lb."""
    positions = torch.as_tensor(system.positions, dtype=torch.float64, device=device)
    f64 = lambda x: torch.as_tensor(x, dtype=torch.float64, device=device)  # noqa: E731
    classes = system.shell_classes
    ls = sorted(classes)
    groups: list[PairGroup] = []
    for la in ls:
        for lb in [l for l in ls if l <= la]:
            ca, cb = classes[la], classes[lb]
            if la == lb:
                ii, jj = np.triu_indices(ca.nshells)
            else:
                ii, jj = np.meshgrid(np.arange(ca.nshells), np.arange(cb.nshells), indexing="ij")
                ii, jj = ii.ravel(), jj.ravel()
            if len(ii) == 0:
                continue
            a = f64(ca.alphas[ii])[:, :, None]
            b = f64(cb.alphas[jj])[:, None, :]
            cc = f64(ca.coefs[ii])[:, :, None] * f64(cb.coefs[jj])[:, None, :]
            A = positions[torch.as_tensor(ca.atom_indices[ii], device=device)]
            B = positions[torch.as_tensor(cb.atom_indices[jj], device=device)]
            AB = (A - B)[:, None, None, :]
            E, p, P = _pair_hermite(la, lb, a, b, cc, A, B, AB)
            groups.append(
                PairGroup(
                    la=la, lb=lb,
                    i_shell=ca.shell_indices[ii], j_shell=cb.shell_indices[jj],
                    ao_i=ca.ao_offsets[ii], ao_j=cb.ao_offsets[jj],
                    p=p, P=P, E=E,
                )
            )
    return groups


@lru_cache(maxsize=None)
def _r2_gather(Lbra: int, Lket: int) -> tuple[np.ndarray, np.ndarray]:
    """Static gather plan: R2[s1, s2] = sign[s2] * Rfull[idx[s1, s2]]."""
    hb = hermite_components(Lbra)
    hk = hermite_components(Lket)
    index = hermite_index(Lbra + Lket)
    idx = np.empty((len(hb), len(hk)), dtype=np.int32)
    sign = np.empty(len(hk))
    for s2, (t2, u2, v2) in enumerate(hk):
        sign[s2] = (-1.0) ** (t2 + u2 + v2)
        for s1, (t1, u1, v1) in enumerate(hb):
            idx[s1, s2] = index[(t1 + t2, u1 + u2, v1 + v2)]
    return idx, sign


@lru_cache(maxsize=None)
def _r2m_plan(Lbra: int, Lket: int, a: int, c: int):
    """Static plan mapping the leading-axis R table (H, a*c, ...) onto the
    fused quartet contraction matrix R2m[(a,s1), (c,s2), ...]:

        h_arr[k, m]  = hermite_index(s1 + s2)
        ac_arr[k, m] = a_i * c + c_j
        sign[m]      = (-1)^{|s2|}
    """
    S1 = nhermite(Lbra)
    S2 = nhermite(Lket)
    idx, sign = _r2_gather(Lbra, Lket)
    ai = np.arange(a)[:, None, None, None]
    cj = np.arange(c)[None, None, :, None]
    h_arr = np.broadcast_to(idx[None, :, None, :], (a, S1, c, S2))
    ac_arr = np.broadcast_to((ai * c + cj), (a, S1, c, S2))
    h_arr = np.ascontiguousarray(h_arr.reshape(a * S1, c * S2), dtype=np.int64)
    ac_arr = np.ascontiguousarray(ac_arr.reshape(a * S1, c * S2), dtype=np.int64)
    sign_m = np.tile(sign, c)  # (c*S2,)
    return h_arr, ac_arr, sign_m


def _eri_chunk_core(Lbra: int, Lket: int, E1, p1, P1, E2, p2, P2):
    """Contracted ERI block for a batch of shell quartets.

    E1 (n,a,A,s1), p1 (n,a), P1 (n,a,3); E2 (n,c,C,s2), p2 (n,c), P2 (n,c,3).
    Returns (n, A, C).
    """
    ps = p1[:, :, None] + p2[:, None, :]  # (n,a,c)
    alpha = p1[:, :, None] * p2[:, None, :] / ps
    PQ = P1[:, :, None, :] - P2[:, None, :, :]  # (n,a,c,3)
    R = r_table_leading(Lbra + Lket, alpha, PQ)  # (H,n,a,c)
    pref = 2.0 * math.pi**2.5 / (p1[:, :, None] * p2[:, None, :] * torch.sqrt(ps))
    R = R * pref[None]
    idx, sign = _r2_gather(Lbra, Lket)
    dev = R.device
    R2 = R[torch.as_tensor(idx, dtype=torch.long, device=dev)]  # (s1,s2,n,a,c)
    R2 = R2 * torch.as_tensor(sign, dtype=R.dtype, device=dev)[None, :, None, None, None]
    T1 = torch.einsum("naAs,stnac->nctA", E1, R2)
    return torch.einsum("nctA,ncCt->nAC", T1, E2)
