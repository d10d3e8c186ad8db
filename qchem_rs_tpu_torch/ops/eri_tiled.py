"""Tiled pair-space ERI engine (port of ``qchem_rs_tpu/ops/eri_tiled.py``).

All unique AO pairs get a flat index; the two-electron integrals form the
symmetric matrix ``V2[(P,ab), (Q,cd)] = (ab|cd)``, assembled class-block by
class-block from Schwarz-screened (bra-pair tile x ket-pair tile) grids.
The RHF operator ``terms[ij, kl] = (ij|kl) - 1/2 (ik|jl)`` is then two
gathers from the mirrored V2 per AO row (``finish_terms``).

Per class pair, ``build`` hands batches of tiles to kernel 1
(``ops/eri_kernel.bra_tiles``: pair geometry, Boys, Hermite R, prefactor,
(s1, s2) reorder and the bra Hermite->Cartesian contraction), contracts the
ket side with one batched f64 matmul (``ket_contract``) and writes the
blocks into V2 by one indexed assignment.

Tile sizes are the port's own: a class's pairs are padded to a multiple of
its tile size min(32, next power of two of its pair count). Padded pairs
carry E = 0 (contribute exactly zero) and p = 1, P = 0 (finite math).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from qchem_rs_tpu_torch.ops.angular import ncart
from qchem_rs_tpu_torch.ops.eri import PairGroup, build_pair_groups
from qchem_rs_tpu_torch.ops.eri_kernel import bra_tiles, bra_tiles_plain
from qchem_rs_tpu_torch.ops.fock import schwarz_bounds
from qchem_rs_tpu_torch.ops.mcmurchie import nhermite
from qchem_rs_tpu_torch.utils.system import MolecularSystem

#: largest pair-tile edge
TILE = 32
#: device bytes one tile batch may take (kernel output, or the twin's R
#: tables on the CPU path)
BATCH_BYTES = 1 << 29


def _pow2_ceil(x: int) -> int:
    return 1 << max(0, (int(x) - 1).bit_length())


@dataclasses.dataclass
class _ClassMeta:
    """Host-side layout of one (la, lb) pair class inside V2."""

    la: int
    lb: int
    A: int  # ncart(la) * ncart(lb) components per pair
    npairs: int
    npad: int  # padded pair count (tile multiple)
    tile: int  # pair-tile edge of this class
    row_base: int  # first V2 row of this class
    a: int  # padded primitive-pair count


def pad_group(g: PairGroup, npad: int):
    """A group's (E, p, P) padded to npad pairs (E=0 so padded pairs
    contribute exactly zero; p=1/P=0 keep the math NaN-free)."""
    pad = npad - g.npairs
    E = torch.cat([g.E, g.E.new_zeros((pad,) + g.E.shape[1:])])
    p = torch.cat([g.p, g.p.new_ones((pad,) + g.p.shape[1:])])
    P = torch.cat([g.P, g.P.new_zeros((pad,) + g.P.shape[1:])])
    return E.contiguous(), p.contiguous(), P.contiguous()


class PairSpaceLayout:
    """Host bookkeeping: class order, V2 row bases, AO-pair -> V2-row map."""

    def __init__(self, system: MolecularSystem, groups: list[PairGroup]):
        self.groups = groups
        self.metas: list[_ClassMeta] = []
        row = 0
        for g in groups:
            A = ncart(g.la) * ncart(g.lb)
            tile = min(TILE, _pow2_ceil(g.npairs))
            npad = tile * -(-g.npairs // tile)
            self.metas.append(
                _ClassMeta(la=g.la, lb=g.lb, A=A, npairs=g.npairs, npad=npad,
                           tile=tile, row_base=row, a=g.p.shape[1])
            )
            row += npad * A
        self.M = row

        nao = system.n_basis_cart()
        pmap = np.full((nao, nao), -1, dtype=np.int64)
        for g, m in zip(groups, self.metas):
            ncA, ncB = ncart(g.la), ncart(g.lb)
            for k in range(g.npairs):
                base = m.row_base + k * m.A
                ii = g.ao_i[k] + np.arange(ncA)
                jj = g.ao_j[k] + np.arange(ncB)
                rows = base + (np.arange(ncA)[:, None] * ncB + np.arange(ncB)[None, :])
                pmap[ii[:, None], jj[None, :]] = rows
                pmap[jj[None, :], ii[:, None]] = rows  # (ji| == (ij|
        if (pmap < 0).any():
            raise RuntimeError("AO pair map has holes")
        self.pmap = pmap.reshape(-1)  # (nao^2,)


def _tile_list(m1, m2, T1, T2, bound1, bound2, threshold, same):
    """Host: Schwarz-screened (ti, tj) pair-offset lists for the tile grid,
    plus each kept tile's Schwarz bound product (1.0 when unscreened)."""
    nb1 = m1.npad // T1
    nb2 = m2.npad // T2
    keep_i, keep_j, keep_b = [], [], []
    if bound1 is not None:
        b1 = np.zeros(m1.npad)
        b1[: m1.npairs] = bound1
        tmax1 = b1.reshape(nb1, T1).max(axis=1)
        b2 = np.zeros(m2.npad)
        b2[: m2.npairs] = bound2
        tmax2 = b2.reshape(nb2, T2).max(axis=1)
    else:
        tmax1 = np.ones(nb1)
        tmax2 = np.ones(nb2)
    for i in range(nb1):
        if i * T1 >= m1.npairs:
            break
        for j in range(nb2):
            if j * T2 >= m2.npairs:
                break
            if same and (j + 1) * T2 <= i * T1:
                continue  # strictly below the diagonal: mirrored later
            b = tmax1[i] * tmax2[j]
            if bound1 is not None and b <= threshold:
                continue
            keep_i.append(i * T1)
            keep_j.append(j * T2)
            keep_b.append(b)
    return (
        np.asarray(keep_i, np.int64),
        np.asarray(keep_j, np.int64),
        np.asarray(keep_b, np.float64),
    )


def _tile_flops(m1: _ClassMeta, m2: _ClassMeta, T1: int, T2: int) -> float:
    """Analytic FLOPs of one grid tile (the JAX package's model, so rates
    compare across implementations): elementwise pair geometry, Boys,
    (-2p)^n powers and prefactor, the R recursion, the (s1, s2) signs and
    the two Hermite->Cartesian contractions at 2*M*N*K."""
    L = m1.la + m1.lb + m2.la + m2.lb
    H = nhermite(L)
    S1 = nhermite(m1.la + m1.lb)
    S2 = nhermite(m2.la + m2.lb)
    a, c = m1.a, m2.a
    A, C = m1.A, m2.A
    grid = float(a * c)
    elem = 12.0 * grid
    boys_f = (24.0 + 3.0 * L) * grid
    base = (2.0 * (L + 1) + 8.0) * grid
    rrec = (3.0 * H * L + 5.0 * H) * grid
    r2m = float(a * S1 * c * S2)
    dots = 2.0 * (a * S1) * (c * S2) * A + 2.0 * (c * S2) * A * C
    return float(T1 * T2) * (elem + boys_f + base + rrec + r2m + dots)


def ket_contract(bra: torch.Tensor, E2: torch.Tensor, tj: np.ndarray, T2: int) -> torch.Tensor:
    """Ket Hermite->Cartesian contraction of bra-contracted tiles.

    bra (nt, A, c*S2, T1, T2) from ``bra_tiles``; E2 (N2, c, C, S2) the ket
    class. Returns the (nt, T1*A, T2*C) V2 blocks, rows (t1, alpha) and
    columns (t2, gamma)."""
    nt, A, cS2, T1, _ = bra.shape
    C = E2.shape[2]
    i2 = torch.as_tensor(tj[:, None] + np.arange(T2)[None, :], dtype=torch.long, device=bra.device)
    E2t = E2[i2].permute(0, 1, 2, 4, 3).reshape(nt * T2, cS2, C)  # (nt*T2, (c,s2), C)
    x = bra.permute(0, 4, 3, 1, 2).reshape(nt * T2, T1 * A, cS2)  # (nt*T2, (t1,alpha), (c,s2))
    out = torch.bmm(x, E2t).reshape(nt, T2, T1 * A, C)
    return out.permute(0, 2, 1, 3).reshape(nt, T1 * A, T2 * C)


def _tile_vals(Lb: int, Lk: int, E1, p1, P1, E2, p2, P2):
    """One grid tile, the plain twin of the whole chain: (T1 bra pairs) x
    (T2 ket pairs) -> (T1*A, T2*C) block. E1 (T1, a, A, S1), p1 (T1, a),
    P1 (T1, a, 3); ket analogous — the JAX ``_tile_vals`` layouts."""
    T1, T2 = E1.shape[0], E2.shape[0]
    zero = np.zeros(1, np.int64)
    bra = bra_tiles_plain(Lb, Lk, E1, p1, P1, p2, P2, zero, zero, T1, T2)
    return ket_contract(bra, E2, zero, T2)[0]


def mirror_inplace(V2: torch.Tensor, block: int = 2048) -> torch.Tensor:
    """Fill the strictly-lower triangle of the upper-valid V2 from its
    transpose, block by block, in place (port of
    ``qchem_rs_tpu/ops/fock_pair.py:77``): peak memory is V2 plus one
    (block, block) temporary."""
    M = V2.shape[0]
    for r0 in range(0, M, block):
        r1 = min(r0 + block, M)
        for c0 in range(0, r0 + 1, block):
            c1 = min(c0 + block, M)
            if r0 == c0:
                blk = V2[r0:r1, c0:c1]
                V2[r0:r1, c0:c1] = torch.triu(blk) + torch.triu(blk, 1).T
            else:
                V2[r0:r1, c0:c1] = V2[c0:c1, r0:r1].T
    return V2


class TiledEriEngine:
    """Builds the pair-space ERI matrix V2 and the RHF operator from it.

        eng = TiledEriEngine(system, 1e-12, device=device)
        V2 = eng.build()                 # upper class blocks valid
        terms = eng.finish_terms(V2)     # (n^2, n^2); V2 is mirrored in place
    """

    def __init__(self, system: MolecularSystem, screening_threshold: float = 0.0, *, device):
        self.system = system
        self.device = torch.device(device)
        self.nao = system.n_basis_cart()
        self.threshold = screening_threshold
        groups = build_pair_groups(system, self.device)
        bounds = None
        if screening_threshold > 0:
            bounds = schwarz_bounds(groups)
            # sort each class's pairs by DESCENDING Schwarz bound so tile
            # blocks are bound-coherent: a tile's max bound then reflects
            # all its pairs, which makes tile-level screening sharp
            orders = [np.argsort(-b, kind="stable") for b in bounds]
            groups = [g.take(o) for g, o in zip(groups, orders)]
            bounds = [b[o] for b, o in zip(bounds, orders)]
        #: per-class Schwarz bounds in the stored (sorted) pair order
        self.bounds = bounds
        self.layout = PairSpaceLayout(system, groups)
        metas = self.layout.metas
        self._padded = [pad_group(g, m.npad) for g, m in zip(groups, metas)]
        #: (i1, i2, ti, tj) per class pair with at least one kept tile
        self._tasks = []
        for i1, m1 in enumerate(metas):
            for i2 in range(i1, len(metas)):
                m2 = metas[i2]
                ti, tj, _ = _tile_list(
                    m1, m2, m1.tile, m2.tile,
                    None if bounds is None else bounds[i1],
                    None if bounds is None else bounds[i2],
                    self.threshold, same=(i2 == i1),
                )
                if len(ti):
                    self._tasks.append((i1, i2, ti, tj))

    def batches(self, twin: bool = False):
        """Every kernel-1 call of one ``build``: (i1, i2, ti, tj) with the
        tile lists cut so that one batch stays under BATCH_BYTES — sized for
        the kernel's output on CUDA, for the twin's R tables on the CPU or
        when ``twin`` is set."""
        metas = self.layout.metas
        twin = twin or self.device.type != "cuda"
        for i1, i2, ti, tj in self._tasks:
            m1, m2 = metas[i1], metas[i2]
            L = m1.la + m1.lb + m2.la + m2.lb
            S1, S2 = nhermite(m1.la + m1.lb), nhermite(m2.la + m2.lb)
            per_tile = m1.tile * m2.tile * m2.a * 8 * (
                m1.a * (2 * nhermite(L) + 2 * S1 * S2) if twin else m1.A * S2
            )
            step = max(1, BATCH_BYTES // per_tile)
            for s in range(0, len(ti), step):
                yield i1, i2, ti[s : s + step], tj[s : s + step]

    def bra_batch(self, i1, i2, ti, tj, fn=bra_tiles) -> torch.Tensor:
        """Kernel 1 (or ``fn``) on one batch of tiles of class pair (i1, i2)."""
        m1, m2 = self.layout.metas[i1], self.layout.metas[i2]
        E1, p1, P1 = self._padded[i1]
        _, p2, P2 = self._padded[i2]
        return fn(m1.la + m1.lb, m2.la + m2.lb, E1, p1, P1, p2, P2, ti, tj, m1.tile, m2.tile)

    def build(self) -> torch.Tensor:
        """All screened tiles of all class pairs into V2 (upper class
        blocks valid)."""
        M = self.layout.M
        metas = self.layout.metas
        V2 = torch.zeros((M, M), dtype=torch.float64, device=self.device)
        for i1, i2, ti, tj in self.batches():
            m1, m2 = metas[i1], metas[i2]
            vals = ket_contract(self.bra_batch(i1, i2, ti, tj), self._padded[i2][0], tj, m2.tile)
            rows = m1.row_base + ti[:, None, None] * m1.A + np.arange(m1.tile * m1.A)[None, :, None]
            cols = m2.row_base + tj[:, None, None] * m2.A + np.arange(m2.tile * m2.A)[None, None, :]
            V2[torch.as_tensor(rows, device=self.device),
               torch.as_tensor(cols, device=self.device)] = vals
        return V2

    def analytic_build_flops(self) -> float:
        """Analytic FLOP count of one ``build()`` over all executed tiles;
        divide by the measured build time for a rate comparable with the
        JAX package's."""
        metas = self.layout.metas
        return sum(
            _tile_flops(metas[i1], metas[i2], metas[i1].tile, metas[i2].tile) * len(ti)
            for i1, i2, ti, _ in self._tasks
        )

    def finish_terms(self, V2: torch.Tensor) -> torch.Tensor:
        """(n^2, n^2) operator terms[ij, kl] = (ij|kl) - 1/2 (ik|jl)
        (rhf.rs:58-62), one AO row i at a time: two gathers from the
        mirrored V2 give (ij|kl) for all j, k, l, and the exchange term is
        its j <-> k transpose. Mirrors V2 in place; peak memory is V2 plus
        the output."""
        n = self.nao
        V2f = mirror_inplace(V2)
        pmap = torch.as_tensor(self.layout.pmap, device=V2.device)
        pmap2 = pmap.reshape(n, n)
        terms = torch.empty((n * n, n * n), dtype=V2.dtype, device=V2.device)
        for i in range(n):
            yb = V2f[pmap2[i]][:, pmap].reshape(n, n, n)  # [j, k, l] = (ij|kl)
            terms[i * n : (i + 1) * n] = (yb - 0.5 * yb.transpose(0, 1)).reshape(n, n * n)
        return terms
