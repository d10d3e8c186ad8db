"""McMurchie-Davidson Hermite-Gaussian machinery on tensors (port of
``qchem_rs_tpu/ops/mcmurchie.py``).

Conventions (standard MD, e.g. Helgaker/Jorgensen/Olsen ch. 9):

- E_t^{ij} Hermite expansion coefficients per dimension, recursion
    E_0^{00} = exp(-mu X_AB^2),  mu = ab/p,  p = a + b
    E_t^{i+1,j} = E_{t-1}^{ij}/(2p) + X_PA E_t^{ij} + (t+1) E_{t+1}^{ij}
    E_t^{i,j+1} = E_{t-1}^{ij}/(2p) + X_PB E_t^{ij} + (t+1) E_{t+1}^{ij}
- Hermite Coulomb integrals R_{tuv} via
    R^{(n)}_{000} = (-2p)^n F_n(p |PC|^2)
    R^{(n)}_{t+1,u,v} = t R^{(n+1)}_{t-1,u,v} + X_PC R^{(n+1)}_{t,u,v}   (etc.)

The static plans (``hermite_components``, ``_r_plan``,
``cart_hermite_gather``) are numpy and also feed the CUDA tile kernel.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from qchem_rs_tpu_torch.ops.angular import cart_components
from qchem_rs_tpu_torch.ops.boys import boys


@lru_cache(maxsize=None)
def hermite_components(L: int) -> tuple[tuple[int, int, int], ...]:
    """All (t, u, v) with t+u+v <= L, in a fixed deterministic order."""
    return tuple(
        (t, u, v)
        for t in range(L + 1)
        for u in range(L + 1 - t)
        for v in range(L + 1 - t - u)
    )


@lru_cache(maxsize=None)
def hermite_index(L: int) -> dict[tuple[int, int, int], int]:
    return {tuv: s for s, tuv in enumerate(hermite_components(L))}


def nhermite(L: int) -> int:
    return (L + 1) * (L + 2) * (L + 3) // 6


def _e_step(E, x, inv2p, tcoef):
    """One E-coefficient ladder step over the trailing t axis:
    E'_t = E_{t-1}/(2p) + x E_t + (t+1) E_{t+1}."""
    zero = torch.zeros_like(E[..., :1])
    up = torch.cat([zero, E[..., :-1]], dim=-1)
    down = torch.cat([E[..., 1:] * tcoef, zero], dim=-1)
    return inv2p * up + x * E + down


def e_cubes(imax: int, jmax: int, a, b, AB):
    """Hermite expansion coefficient cubes for all three dimensions.

    a, b: exponents, any broadcast-compatible batch shape ``B``; AB: A - B,
    shape ``B + (3,)``. Returns three tensors (x, y, z) of shape
    ``B + (imax+1, jmax+1, imax+jmax+1)``; entry [..., i, j, t] is E_t^{ij}.
    """
    p = a + b
    inv2p = 0.5 / p
    mu = a * b / p
    tmax = imax + jmax
    tcoef = torch.arange(1, tmax + 1, dtype=p.dtype, device=p.device)
    cubes = []
    for d in range(3):
        ab_d = AB[..., d]
        xpa = -(b / p) * ab_d  # P - A
        xpb = (a / p) * ab_d  # P - B
        e00 = torch.exp(-mu * ab_d * ab_d)
        row = torch.cat(
            [e00[..., None], torch.zeros(e00.shape + (tmax,), dtype=e00.dtype, device=e00.device)],
            dim=-1,
        )
        rows = [row]
        for _ in range(imax):
            row = _e_step(row, xpa[..., None], inv2p[..., None], tcoef)
            rows.append(row)
        cube = torch.stack(rows, dim=-2)  # B + (imax+1, tmax+1)
        planes = [cube]
        for _ in range(jmax):
            cube = _e_step(cube, xpb[..., None, None], inv2p[..., None, None], tcoef)
            planes.append(cube)
        cubes.append(torch.stack(planes, dim=-2))  # B + (imax+1, jmax+1, tmax+1)
    return cubes


@lru_cache(maxsize=None)
def _r_plan(L: int):
    """Static plan for the downward R recursion.

    For each Hermite entry s=(t,u,v) (s>0), reduce along the first nonzero
    dimension d: R^{(n)}_s = PC_d R^{(n+1)}_{s-e_d} + c R^{(n+1)}_{s-2e_d}
    with c = (s_d - 1). c == 0 exactly when s-2e_d is out of range, so idx2
    points at 0 in that case. Both indices are smaller than s.
    """
    comps = hermite_components(L)
    index = hermite_index(L)
    H = len(comps)
    onehot = np.zeros((H, 3))
    idx1 = np.zeros(H, dtype=np.int32)
    idx2 = np.zeros(H, dtype=np.int32)
    coef = np.zeros(H)
    for s, (t, u, v) in enumerate(comps):
        if s == 0:
            continue
        if t >= 1:
            d, e1, c = 0, (t - 1, u, v), t - 1
            e2 = (t - 2, u, v)
        elif u >= 1:
            d, e1, c = 1, (t, u - 1, v), u - 1
            e2 = (t, u - 2, v)
        else:
            d, e1, c = 2, (t, u, v - 1), v - 1
            e2 = (t, u, v - 2)
        onehot[s, d] = 1.0
        idx1[s] = index[e1]
        idx2[s] = index[e2] if c > 0 else 0
        coef[s] = c
    return onehot, idx1, idx2, coef


def r_table_leading(L: int, p, PC):
    """Hermite Coulomb integrals R_{tuv} = R^{(0)}_{tuv}(p, PC) for all
    t+u+v <= L, stacked along the LEADING axis in ``hermite_components(L)``
    order: shape ``(nhermite(L),) + B``, with B the broadcast batch shape of
    ``p`` and ``PC[..., 0]``.

    Level-by-level downward recursion in the auxiliary index n; entries
    whose order exceeds L - n at level n are garbage-but-finite and never
    feed a valid entry.
    """
    PCx, PCy, PCz = PC[..., 0], PC[..., 1], PC[..., 2]
    return r_table_components(L, p, PCx, PCy, PCz)


@lru_cache(maxsize=None)
def _r_raise_plan(L: int):
    """(keep, up): the positions in ``hermite_components(L + 1)`` of every
    entry s of ``hermite_components(L)``, and of s + e_d for d = x, y, z
    (up, (3, H))."""
    index = hermite_index(L + 1)
    comps = hermite_components(L)
    keep = np.array([index[s] for s in comps], dtype=np.int64)
    up = np.array([[index[(t + (d == 0), u + (d == 1), v + (d == 2))] for (t, u, v) in comps]
                   for d in range(3)], dtype=np.int64)
    return keep, up


class _HermiteR(torch.autograd.Function):
    """The R table with its derivative in PC by the Hermite identity
    d R_{tuv} / d PC_x = R_{t+1,u,v} (and so for y, z): one table at L + 1
    serves the values and the backward, so autograd never runs through the
    recursion or the Boys function. p is held constant (its derivative is
    not needed: exponents do not move with the nuclei)."""

    @staticmethod
    def forward(ctx, L, p, PCx, PCy, PCz):
        R1 = _r_table(L + 1, p, PCx, PCy, PCz)
        keep, up = _r_raise_plan(L)
        ctx.save_for_backward(R1)
        ctx.up = up
        ctx.shapes = (PCx.shape, PCy.shape, PCz.shape)
        return R1[torch.as_tensor(keep, device=R1.device)]

    @staticmethod
    def backward(ctx, grad):
        (R1,) = ctx.saved_tensors
        grads = [None, None]
        for d in range(3):
            if not ctx.needs_input_grad[2 + d]:
                grads.append(None)
                continue
            up = torch.as_tensor(ctx.up[d], device=R1.device)
            grads.append((grad * R1[up]).sum(dim=0).sum_to_size(ctx.shapes[d]))
        return tuple(grads)


def r_table_components(L: int, p, PCx, PCy, PCz):
    """``r_table_leading`` with the three PC components as separate tensors
    (the tile path never builds a trailing 3-vector axis). When autograd
    follows PC (and not p), the table and its backward come from one table
    at L + 1 (``_HermiteR``)."""
    if torch.is_grad_enabled() and not p.requires_grad and (
            PCx.requires_grad or PCy.requires_grad or PCz.requires_grad):
        return _HermiteR.apply(L, p, PCx, PCy, PCz)
    return _r_table(L, p, PCx, PCy, PCz)


def _r_table(L: int, p, PCx, PCy, PCz):
    """The recursion of ``r_table_components``."""
    T = p * (PCx * PCx + PCy * PCy + PCz * PCz)
    F = boys(L, T)  # (L+1,) + B
    m2p = -2.0 * p
    base = []
    acc = torch.ones_like(p)
    for n in range(L + 1):
        base.append(acc * F[n])
        acc = acc * m2p
    bshape = torch.broadcast_shapes(p.shape, PCx.shape, PCy.shape, PCz.shape)
    if L == 0:
        return base[0].expand(bshape)[None]

    onehot, idx1, idx2, coef, pos = _r_level_plan(L)
    H = len(hermite_components(L))
    extra = (1,) * len(bshape)
    dev, dt = p.device, p.dtype
    ox, oy, oz = (
        torch.as_tensor(onehot[:, d], dtype=dt, device=dev).reshape((H,) + extra)
        for d in range(3)
    )
    PCs = ox * PCx[None] + oy * PCy[None] + oz * PCz[None]  # (H,) + B, level order
    coef = torch.as_tensor(coef, dtype=dt, device=dev).reshape((H,) + extra)
    idx1 = torch.as_tensor(idx1, dtype=torch.long, device=dev)
    idx2 = torch.as_tensor(idx2, dtype=torch.long, device=dev)

    R = base[L].expand(bshape)[None]
    for n in range(L - 1, -1, -1):
        k = nhermite(L - n)  # the entries of order <= L - n, valid at level n
        new = PCs[1:k] * R[idx1[1:k]] + coef[1:k] * R[idx2[1:k]]
        R = torch.cat([base[n].expand(bshape)[None], new])
    return R[torch.as_tensor(pos, dtype=torch.long, device=dev)]


@lru_cache(maxsize=None)
def _r_level_plan(L: int):
    """``_r_plan`` in level order: the Hermite entries sorted stably by
    their order t+u+v, so that level n of the recursion computes only its
    valid entries, the first nhermite(L - n). Returns (onehot, idx1, idx2,
    coef) in that order, indices pointing at level-order positions, and
    ``pos``, each entry's position (the gather back to
    ``hermite_components`` order). Every valid entry is computed by the
    same operations on the same operands as in the full-table recursion."""
    onehot, idx1, idx2, coef = _r_plan(L)
    order = np.asarray(hermite_components(L)).sum(axis=1)
    lev = np.argsort(order, kind="stable")  # position -> entry
    pos = np.argsort(lev)  # entry -> position
    return onehot[lev], pos[idx1[lev]], pos[idx2[lev]], coef[lev], pos


@lru_cache(maxsize=None)
def cart_hermite_gather(la: int, lb: int):
    """Static gather indices mapping E cubes -> dense (compAB, tuv) tensor:
    ``(ia, ja, ka)`` and ``(ib, jb, kb)`` per-dimension powers for each
    component pair A, and ``t, u, v`` for each Hermite component S of
    L = la + lb, so that

      E_bra[..., A, S] = Ex[..., ia[A], ib[A], t[S]]
                       * Ey[..., ja[A], jb[A], u[S]]
                       * Ez[..., ka[A], kb[A], v[S]]
    """
    comps_a = cart_components(la)
    comps_b = cart_components(lb)
    A_idx = [(ca, cb) for ca in comps_a for cb in comps_b]
    pa = np.array([[ca[d] for ca, cb in A_idx] for d in range(3)])
    pb = np.array([[cb[d] for ca, cb in A_idx] for d in range(3)])
    tuv = np.array(hermite_components(la + lb)).T  # (3, S)
    return pa, pb, tuv


def hermite_expansion_dense(la: int, lb: int, a, b, AB):
    """Dense Hermite expansion tensor E[..., A, S] for a shell-pair class.

    A indexes Cartesian component pairs (ncart(la) * ncart(lb)), S indexes
    Hermite components of order la+lb. Batch dims of a/b are preserved.
    """
    cubes = e_cubes(la, lb, a, b, AB)
    pa, pb, tuv = cart_hermite_gather(la, lb)
    dev = AB.device
    out = None
    for d in range(3):
        ia = torch.as_tensor(pa[d], device=dev)[:, None]
        ib = torch.as_tensor(pb[d], device=dev)[:, None]
        t = torch.as_tensor(tuv[d], device=dev)[None, :]
        g = cubes[d][..., ia, ib, t]  # (..., A, S)
        out = g if out is None else out * g
    return out
