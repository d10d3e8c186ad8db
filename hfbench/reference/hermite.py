"""McMurchie-Davidson building blocks: the Boys function, Hermite expansion
coefficients E and Hermite Coulomb integrals R, elementwise over tensors of
any shape, in the dtype of their inputs (float64 for the reference,
float32 for its control).
"""

from __future__ import annotations

import math
from functools import lru_cache

import torch


def boys(mmax: int, T: torch.Tensor) -> torch.Tensor:
    """F_0..F_mmax at T, shape (mmax + 1,) + T.shape.

    T <= mmax + 1.5: the series F_mmax = exp(-T) sum_k (2T)^k /
    ((2 mmax + 1)(2 mmax + 3)...(2 mmax + 2k + 1)), 2 mmax + 60 terms,
    then the downward recursion F_{m-1} = (2T F_m + exp(-T)) / (2m - 1).
    T > mmax + 1.5: F_0 = sqrt(pi / T) erf(sqrt T) / 2 and the upward
    recursion F_{m+1} = ((2m + 1) F_m - exp(-T)) / (2T)."""
    out = T.new_empty((mmax + 1,) + T.shape)
    small = T <= mmax + 1.5
    Ts, Tb = T[small], T[~small]
    if Ts.numel():
        e = torch.exp(-Ts)
        term = torch.full_like(Ts, 1.0 / (2 * mmax + 1))
        total = term.clone()
        for k in range(1, 2 * mmax + 61):
            term = term * (2.0 / (2 * mmax + 2 * k + 1)) * Ts
            total = total + term
        f = [e * total]
        for m in range(mmax, 0, -1):
            f.append((2.0 * Ts * f[-1] + e) / (2 * m - 1))
        out[:, small] = torch.stack(f[::-1])
    if Tb.numel():
        e = torch.exp(-Tb)
        r = torch.sqrt(Tb)
        f = [0.5 * math.sqrt(math.pi) * torch.erf(r) / r]
        for m in range(mmax):
            f.append(((2 * m + 1) * f[-1] - e) / (2.0 * Tb))
        out[:, ~small] = torch.stack(f)
    return out


def expansion_1d(la: int, lb: int, a, b, xab) -> list:
    """E[i][j][t] (i <= la, j <= lb, t <= i + j) of the 1D product
    x_A^i x_B^j exp(-a x_A^2 - b x_B^2) = sum_t E^{ij}_t Lambda_t, as nested
    lists of tensors broadcast from a, b and xab = A - B."""
    p = a + b
    mu = a * b / p
    xpa, xpb, h = -b / p * xab, a / p * xab, 0.5 / p
    zero = torch.zeros_like(p * xab)
    E = [[None] * (lb + 1) for _ in range(la + 1)]
    E[0][0] = [torch.exp(-mu * xab * xab) + zero]

    def at(e, t):
        return e[t] if 0 <= t < len(e) else zero

    for i in range(la + 1):
        for j in range(lb + 1):
            if i == 0 and j == 0:
                continue
            if j == 0:
                e, x = E[i - 1][0], xpa
            else:
                e, x = E[i][j - 1], xpb
            E[i][j] = [h * at(e, t - 1) + x * at(e, t) + (t + 1) * at(e, t + 1)
                       for t in range(i + j + 1)]
    return E


@lru_cache(maxsize=None)
def hermite_list(L: int) -> tuple[tuple[int, int, int], ...]:
    """Every (t, u, v) with t + u + v <= L, ordered by t + u + v, so that
    the first hermite_count(L') entries are those of any L' <= L."""
    return tuple((t, u, s - t - u) for s in range(L + 1) for t in range(s, -1, -1)
                 for u in range(s - t, -1, -1))


def hermite_count(L: int) -> int:
    return (L + 1) * (L + 2) * (L + 3) // 6


@lru_cache(maxsize=None)
def _r_plan(L: int):
    """For every entry past the first: (dir, index of tuv - e_dir, index of
    tuv - 2 e_dir or 0, the factor of that term)."""
    comps = hermite_list(L)
    index = {c: k for k, c in enumerate(comps)}
    d, i1, i2, c2 = [], [], [], []
    for tuv in comps[1:]:
        k = next(k for k in range(3) if tuv[k] > 0)
        down = list(tuv)
        down[k] -= 1
        d.append(k)
        i1.append(index[tuple(down)])
        if tuv[k] > 1:
            down[k] -= 1
            i2.append(index[tuple(down)])
            c2.append(float(tuv[k] - 1))
        else:
            i2.append(0)
            c2.append(0.0)
    return d, i1, i2, c2


def hermite_r(L: int, p, PC) -> torch.Tensor:
    """R_tuv(p, PC) for every tuv of ``hermite_list(L)``: shape
    (hermite_count(L),) + p.shape, with PC (..., 3). Built level by level
    from R^n_000 = (-2p)^n F_n(p |PC|^2) down to n = 0 by
    R^n_{tuv+e} = t_e R^{n+1}_{tuv-e} + PC_e R^{n+1}_{tuv}."""
    F = boys(L, p * (PC * PC).sum(-1))
    if L == 0:
        return F
    d, i1, i2, c2 = _r_plan(L)
    dev = p.device
    d, i1, i2 = (torch.as_tensor(x, device=dev) for x in (d, i1, i2))
    c2 = torch.as_tensor(c2, dtype=p.dtype, device=dev)
    X = PC.movedim(-1, 0)  # (3, ...)
    shape = (-1,) + (1,) * p.dim()
    level = F[L:L + 1] * (-2.0 * p) ** L
    for n in range(L - 1, -1, -1):
        m = hermite_count(L - n) - 1
        rest = c2[:m].view(shape) * level[i2[:m]] + X[d[:m]] * level[i1[:m]]
        level = torch.cat([(F[n] * (-2.0 * p) ** n)[None], rest])
    return level
