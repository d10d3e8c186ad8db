"""One- and two-electron integrals over the Cartesian AOs of a ``Molecule``
by McMurchie-Davidson, in plain torch.

Shell pairs are batched by (la, lb, Ka, Kb), so that a batch is dense and
carries no padding. The two-electron integrals are Schwarz-screened at
shell-pair granularity, (ab|ab)^1/2 (cd|cd)^1/2 > threshold, and stored
once per unique AO-pair pair in the pair-space matrix V[ij, kl] = (ij|kl),
i >= j, k >= l; ``fock_operator`` expands it to the RHF operator
G[ij, kl] = (ij|kl) - 1/2 (ik|jl), so that G(D) = G @ vec(D).
"""

from __future__ import annotations

import dataclasses
import math
from functools import lru_cache

import numpy as np
import torch

from hfbench.reference.hermite import expansion_1d, hermite_count, hermite_list, hermite_r
from hfbench.reference.molecule import Molecule, cartesian_powers, component_factors


def ncart(l: int) -> int:
    return (l + 1) * (l + 2) // 2


def _batches(mol: Molecule, pairs):
    """Shell pairs grouped by (la, lb, Ka, Kb): {key: [(A, B), ...]}."""
    out = {}
    for A, B in pairs:
        sa, sb = mol.shells[A], mol.shells[B]
        out.setdefault((sa.l, sb.l, len(sa.exponents), len(sb.exponents)), []).append((A, B))
    return out


def _prims(mol: Molecule, pairs, lb_extra: int, dtype, device):
    """Per batch of pairs: exponents a (n, Ka, 1), b (n, 1, Kb), coefficient
    products (n, Ka, Kb), centres A, B (n, 3) and the 1D expansions of the
    three directions (up to lb + lb_extra on the B side)."""
    sa = [mol.shells[A] for A, _ in pairs]
    sb = [mol.shells[B] for _, B in pairs]
    t = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.float64, device=device)  # noqa: E731
    a = t([s.exponents for s in sa])[:, :, None]
    b = t([s.exponents for s in sb])[:, None, :]
    cc = t([s.coefficients for s in sa])[:, :, None] * t([s.coefficients for s in sb])[:, None, :]
    RA = t(mol.positions[[s.atom for s in sa]])
    RB = t(mol.positions[[s.atom for s in sb]])
    la, lb = sa[0].l, sb[0].l
    E1 = [expansion_1d(la, lb + lb_extra, a, b, (RA - RB)[:, k, None, None]) for k in range(3)]
    cast = lambda x: x.to(dtype)  # noqa: E731
    return la, lb, cast(a), cast(b), cast(cc), cast(RA), cast(RB), [
        [[[cast(e) for e in Eij] for Eij in Ei] for Ei in Ed] for Ed in E1]


def _hermite_3d(la, lb, E1, cc):
    """(n, Ka, Kb, A, S) Hermite expansion of every Cartesian component
    pair, with coefficients and component norms folded in."""
    L = la + lb
    zero = torch.zeros_like(cc)
    na, nb = component_factors(la), component_factors(lb)
    rows = []
    for ia, (ax, ay, az) in enumerate(cartesian_powers(la)):
        for ib, (bx, by, bz) in enumerate(cartesian_powers(lb)):
            ex, ey, ez = E1[0][ax][bx], E1[1][ay][by], E1[2][az][bz]
            f = cc * (na[ia] * nb[ib])
            rows.append(torch.stack([
                f * ex[t] * ey[u] * ez[v] if t < len(ex) and u < len(ey) and v < len(ez) else zero
                for t, u, v in hermite_list(L)], dim=-1))
    return torch.stack(rows, dim=-2)


def one_electron(mol: Molecule, dtype=torch.float64, device="cpu"):
    """(S, T, V): overlap, kinetic energy and nuclear attraction, (nao, nao)."""
    n = mol.nao
    S, T, V = (torch.zeros((n, n), dtype=dtype, device=device) for _ in range(3))
    Z = torch.as_tensor(mol.numbers, dtype=dtype, device=device)
    C = torch.as_tensor(mol.positions, dtype=dtype, device=device)
    pairs = [(A, B) for A in range(len(mol.shells)) for B in range(A + 1)]
    for group in _batches(mol, pairs).values():
        la, lb, a, b, cc, RA, RB, E1 = _prims(mol, group, 2, dtype, device)
        p = a + b
        P = (a[..., None] * RA[:, None, None] + b[..., None] * RB[:, None, None]) / p[..., None]
        s1 = [[[Eij[0] * torch.sqrt(math.pi / p) for Eij in Ei] for Ei in Ed] for Ed in E1]

        def kin(s, i, j):
            k = -2.0 * b * b * s[i][j + 2] + b * (2 * j + 1) * s[i][j]
            return k - 0.5 * j * (j - 1) * s[i][j - 2] if j >= 2 else k

        na, nb = component_factors(la), component_factors(lb)
        sblk, tblk = [], []
        for ia, (ax, ay, az) in enumerate(cartesian_powers(la)):
            for ib, (bx, by, bz) in enumerate(cartesian_powers(lb)):
                sx, sy, sz = s1[0][ax][bx], s1[1][ay][by], s1[2][az][bz]
                f = cc * (na[ia] * nb[ib])
                sblk.append((f * sx * sy * sz).sum((1, 2)))
                t3 = kin(s1[0], ax, bx) * sy * sz + sx * kin(s1[1], ay, by) * sz + sx * sy * kin(s1[2], az, bz)
                tblk.append((f * t3).sum((1, 2)))
        E3 = _hermite_3d(la, lb, E1, cc)
        R = hermite_r(la + lb, p[..., None], P[..., None, :] - C)  # (H, n, Ka, Kb, natom)
        R = (R * (-2.0 * math.pi) * Z / p[..., None]).sum(-1)
        vblk = torch.einsum("nabcs,snab->nc", E3, R)
        m = len(group)
        ncA, ncB = ncart(la), ncart(lb)
        ao = lambda k, nc: (torch.as_tensor([mol.shells[pair[k]].ao for pair in group], device=device)[:, None]  # noqa: E731
                            + torch.arange(nc, device=device))
        rows, cols = ao(0, ncA), ao(1, ncB)
        for M, blk in ((S, torch.stack(sblk, -1)), (T, torch.stack(tblk, -1)), (V, vblk)):
            blk = blk.reshape(m, ncA, ncB)
            M[rows[:, :, None], cols[:, None, :]] = blk
            M[cols[:, None, :], rows[:, :, None]] = blk
    return S, T, V


@dataclasses.dataclass
class PairBatch:
    """Shell pairs of one (la, lb, Ka, Kb) as the two-electron integrals
    take them."""

    la: int
    lb: int
    E: torch.Tensor  # (n, K, A, S)
    p: torch.Tensor  # (n, K)
    P: torch.Tensor  # (n, K, 3)
    rows: torch.Tensor  # (n, A) AO-pair index i(i+1)/2 + j, i >= j, of each component pair


def shell_pairs(mol: Molecule, dtype=torch.float64, device="cpu") -> list[PairBatch]:
    """Every unique shell pair (A >= B), batched."""
    pairs = [(A, B) for A in range(len(mol.shells)) for B in range(A + 1)]
    out = []
    for group in _batches(mol, pairs).values():
        la, lb, a, b, cc, RA, RB, E1 = _prims(mol, group, 0, dtype, device)
        n = len(group)
        p = a + b
        P = (a[..., None] * RA[:, None, None] + b[..., None] * RB[:, None, None]) / p[..., None]
        E = _hermite_3d(la, lb, E1, cc)
        ia = np.array([mol.shells[A].ao for A, _ in group])[:, None, None] + np.arange(ncart(la))[None, :, None]
        ib = np.array([mol.shells[B].ao for _, B in group])[:, None, None] + np.arange(ncart(lb))[None, None, :]
        hi, lo = np.maximum(ia, ib), np.minimum(ia, ib)
        out.append(PairBatch(la, lb, E.reshape(n, -1, E.shape[-2], E.shape[-1]),
                             p.reshape(n, -1), P.reshape(n, -1, 3),
                             torch.as_tensor((hi * (hi + 1) // 2 + lo).reshape(n, -1), device=device)))
    return out


@lru_cache(maxsize=None)
def _r_gather(L1: int, L2: int):
    """R2[s1, s2] = sign(s2) R[index(s1 + s2)] as (index (S1*S2,), sign (S2,))."""
    index = {c: k for k, c in enumerate(hermite_list(L1 + L2))}
    h1, h2 = hermite_list(L1), hermite_list(L2)
    idx = [index[(a[0] + b[0], a[1] + b[1], a[2] + b[2])] for a in h1 for b in h2]
    return np.array(idx), np.array([(-1.0) ** sum(b) for b in h2])


def quartets(b1: PairBatch, b2: PairBatch, i1, i2) -> torch.Tensor:
    """(ab|cd) of the pairs b1[i1] and b2[i2] (index tensors of one
    length n): (n, A, C)."""
    E1, p1, P1 = b1.E[i1], b1.p[i1], b1.P[i1]
    E2, p2, P2 = b2.E[i2], b2.p[i2], b2.P[i2]
    n, K1, A, S1 = E1.shape
    _, K2, C, S2 = E2.shape
    L1, L2 = b1.la + b1.lb, b2.la + b2.lb
    pq = p1[:, :, None] + p2[:, None, :]
    alpha = p1[:, :, None] * p2[:, None, :] / pq
    R = hermite_r(L1 + L2, alpha, P1[:, :, None, :] - P2[:, None, :, :])  # (H, n, K1, K2)
    R = R * (2.0 * math.pi ** 2.5 / (p1[:, :, None] * p2[:, None, :] * torch.sqrt(pq)))
    idx, sign = _r_gather(L1, L2)
    R2 = R[torch.as_tensor(idx, device=R.device)].view(S1, S2, n, K1, K2)
    R2 = R2 * torch.as_tensor(sign, dtype=R.dtype, device=R.device).view(1, S2, 1, 1, 1)
    R2 = R2.permute(2, 3, 0, 4, 1).reshape(n, K1 * S1, K2 * S2)
    X = torch.bmm(E1.permute(0, 2, 1, 3).reshape(n, A, K1 * S1), R2)
    return torch.bmm(X, E2.permute(0, 1, 3, 2).reshape(n, K2 * S2, C))


def schwarz(batches: list[PairBatch]) -> list[torch.Tensor]:
    """Per batch, (ab|ab)^1/2 of each pair: the largest diagonal element."""
    out = []
    for b in batches:
        q = []
        for s in range(0, len(b.p), 512):
            i = torch.arange(s, min(s + 512, len(b.p)), device=b.p.device)
            q.append(torch.diagonal(quartets(b, b, i, i), dim1=1, dim2=2).abs().amax(1))
        out.append(torch.sqrt(torch.cat(q)))
    return out


def _chunk(b1: PairBatch, b2: PairBatch, budget: int) -> int:
    K1, A, S1 = b1.E.shape[1:]
    K2, C, S2 = b2.E.shape[1:]
    H = hermite_count(b1.la + b1.lb + b2.la + b2.lb)
    per = K1 * K2 * (4 * H + 3 * S1 * S2 + 8) + A * K2 * S2 + A * C
    return max(1, budget // (per * b1.E.element_size()))


def screened_quartets(batches, q, threshold: float):
    """(k1, k2, i1, i2) for every batch pair k1 <= k2 with its kept pair
    pairs: q1 q2 > threshold, each unordered pair pair once."""
    for k1, b1 in enumerate(batches):
        for k2 in range(k1, len(batches)):
            keep = q[k1][:, None] * q[k2][None, :] > threshold
            if k1 == k2:
                keep = torch.triu(keep)
            i1, i2 = torch.nonzero(keep, as_tuple=True)
            if len(i1):
                yield k1, k2, i1, i2


def pair_matrix(mol: Molecule, threshold: float, dtype=torch.float64, device="cpu",
                budget: int = 1 << 30):
    """V (npair, npair), npair = nao (nao + 1) / 2; the Schwarz factors are
    always float64."""
    batches = shell_pairs(mol, dtype, device)
    q = schwarz(shell_pairs(mol, torch.float64, device) if dtype != torch.float64 else batches)
    m = mol.nao * (mol.nao + 1) // 2
    V = torch.zeros((m, m), dtype=dtype, device=device)
    for k1, k2, i1, i2 in screened_quartets(batches, q, threshold):
        b1, b2 = batches[k1], batches[k2]
        step = _chunk(b1, b2, budget)
        for s in range(0, len(i1), step):
            j1, j2 = i1[s:s + step], i2[s:s + step]
            vals = quartets(b1, b2, j1, j2)
            r, c = b1.rows[j1][:, :, None], b2.rows[j2][:, None, :]
            V[r, c] = vals
            V[c, r] = vals
    return V


def fock_operator(V: torch.Tensor, nao: int) -> torch.Tensor:
    """G[ij, kl] = (ij|kl) - 1/2 (ik|jl), (nao^2, nao^2), one AO row i at a
    time from the pair matrix."""
    i = torch.arange(nao, device=V.device)
    hi, lo = torch.maximum(i[:, None], i[None, :]), torch.minimum(i[:, None], i[None, :])
    pmap = hi * (hi + 1) // 2 + lo  # (nao, nao)
    G = torch.empty((nao * nao, nao * nao), dtype=V.dtype, device=V.device)
    flat = pmap.reshape(-1)
    for r in range(nao):
        e = V[pmap[r]][:, flat].view(nao, nao, nao)  # [j, k, l] = (rj|kl)
        G[r * nao:(r + 1) * nao] = (e - 0.5 * e.transpose(0, 1)).reshape(nao, -1)
    return G
