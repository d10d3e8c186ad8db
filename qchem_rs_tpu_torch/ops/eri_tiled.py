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

A spherical system's V2 is still Cartesian; ``finish_eri`` and
``finish_terms`` project it onto the solid harmonics in pair space, one
class-pair block at a time (``SphericalPairLayout``), so the dense
Cartesian (n^4) tensor never exists.

Tile sizes are the port's own: a class's pairs are padded to a multiple of
its tile size min(32, next power of two of its pair count). Padded pairs
carry E = 0 (contribute exactly zero) and p = 1, P = 0 (finite math).
Each pair's primitive pairs are then reordered so that those with nonzero
E come first (``eri_kernel.compact_prims``), and kernel 1 gets their
counts, so it computes only real primitive quartets.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from qchem_rs_tpu_torch.ops.angular import ncart
from qchem_rs_tpu_torch.ops.eri import PairGroup, build_pair_groups
from qchem_rs_tpu_torch.ops.eri_kernel import (KERNEL_MAX_SIDE, bra_tiles, compact_order, compact_prims,
                                               ket_contract, ket_layout, prim_counts, tile_values,
                                               tile_values_plain)
from qchem_rs_tpu_torch.ops.fock import schwarz_bounds
from qchem_rs_tpu_torch.ops.mcmurchie import nhermite
from qchem_rs_tpu_torch.ops.spherical import cart_to_sph, nsph
from qchem_rs_tpu_torch.utils.system import MolecularSystem

#: largest pair-tile edge
TILE = 32
#: device bytes one tile batch may take (kernel 1's or kernel 3's output, or
#: the twin's R tables on the CPU path)
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


class SphericalPairLayout:
    """Host bookkeeping of the spherical pair-space matrix V2s (port of
    ``qchem_rs_tpu/ops/eri_tiled.py::_sph_pair_layout``): per class, its
    first V2s row and its (2la+1)(2lb+1) components per pair (``bases``),
    the class's kron(cart_to_sph(la), cart_to_sph(lb)) block (``kmats``,
    (A_cart, A_sph), the blocks of ``system.sph_T``), and the spherical
    AO-pair -> V2s-row map ``pmap`` (ns^2,).

    The solid-harmonic projection factorises per class pair: each stored
    pair transforms on its own with its kron block, so no Cartesian n^4
    tensor is needed."""

    def __init__(self, system: MolecularSystem, layout: PairSpaceLayout):
        sph_off, off = {}, 0
        for sh in system.shells:
            sph_off[sh.index] = off
            off += nsph(sh.l)
        self.ns = ns = off
        self.bases: list[tuple[int, int]] = []
        row = 0
        for g, m in zip(layout.groups, layout.metas):
            As = nsph(g.la) * nsph(g.lb)
            self.bases.append((row, As))
            row += m.npad * As
        self.Ms = row
        pmap = np.full((ns, ns), -1, dtype=np.int64)
        for g, (base_s, As) in zip(layout.groups, self.bases):
            nA, nB = nsph(g.la), nsph(g.lb)
            for k in range(g.npairs):
                ii = sph_off[int(g.i_shell[k])] + np.arange(nA)
                jj = sph_off[int(g.j_shell[k])] + np.arange(nB)
                rows = base_s + k * As + (np.arange(nA)[:, None] * nB + np.arange(nB)[None, :])
                pmap[ii[:, None], jj[None, :]] = rows
                pmap[jj[None, :], ii[:, None]] = rows
        if (pmap < 0).any():
            raise RuntimeError("spherical AO pair map has holes")
        self.pmap = pmap.reshape(-1)
        self.kmats = [np.kron(cart_to_sph(g.la), cart_to_sph(g.lb)) for g in layout.groups]


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


def _quartet_flops(L: int, S1: int, S2: int, A: int) -> float:
    """FLOPs of one primitive quartet in the bra half of ``_tile_flops``'s
    model: pair geometry, Boys, powers and prefactor, the R recursion, the
    (s1, s2) signs and the bra Hermite->Cartesian contraction."""
    H = nhermite(L)
    return (12.0 + (24.0 + 3.0 * L) + (2.0 * (L + 1) + 8.0) + (3.0 * H * L + 5.0 * H)
            + S1 * S2 + 2.0 * S1 * S2 * A)


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


def _tile_vals(Lb: int, Lk: int, E1, p1, P1, E2, p2, P2):
    """One grid tile, the plain twin of the whole chain: (T1 bra pairs) x
    (T2 ket pairs) -> (T1*A, T2*C) block. E1 (T1, a, A, S1), p1 (T1, a),
    P1 (T1, a, 3); ket analogous — the JAX ``_tile_vals`` layouts."""
    zero = np.zeros(1, np.int64)
    return tile_values_plain(Lb, Lk, E1, p1, P1, E2, p2, P2, zero, zero, E1.shape[0], E2.shape[0])[0]


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
        e4 = eng.finish_eri(eng.build()) # (n, n, n, n) chemists' tensor

    A spherical system's V2 is Cartesian as well; its finish projects it
    (``v2s_mirrored``) and gives the working-basis results.
    """

    def __init__(self, system: MolecularSystem, screening_threshold: float = 0.0, *, device):
        self.system = system
        self.device = torch.device(device)
        self.nao = system.n_basis_cart()
        self.threshold = screening_threshold
        groups = build_pair_groups(system, self.device)
        bounds = orders = None
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
        #: per-class pair orders (None when unscreened) and primitive-pair
        #: orders of this geometry, which ``padded_at`` reuses
        self._orders = orders
        self.layout = PairSpaceLayout(system, groups)
        metas = self.layout.metas
        padded = [pad_group(g, m.npad) for g, m in zip(groups, metas)]
        self._prim_orders = [compact_order(E) for E, _, _ in padded]
        self._padded = [compact_prims(*t, perm) for t, perm in zip(padded, self._prim_orders)]
        #: kernel 1's primitive counts per class
        self._counts = [prim_counts(E, m.tile) for (E, _, _), m in zip(self._padded, metas)]
        #: each class's E in kernel 3's ket-side layouts, made at first use
        self._ket_layouts: dict = {}
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

    def padded_at(self, positions: torch.Tensor) -> list:
        """Every class's padded, compacted (E, p, P) rebuilt at ``positions``
        (natom, 3), a tensor on the engine's device, as functions of it that
        autograd can follow (port of ``padded_groups``,
        ``qchem_rs_tpu/ops/eri_tiled.py:675``). The pair order, padding and
        primitive-pair order are this engine's, fixed at the geometry it
        was built at, as are its tile lists; at that geometry the result
        equals the engine's own operands."""
        groups = build_pair_groups(self.system, self.device, positions=positions)
        if self._orders is not None:
            groups = [g.take(o) for g, o in zip(groups, self._orders)]
        return [compact_prims(*pad_group(g, m.npad), perm)
                for g, m, perm in zip(groups, self.layout.metas, self._prim_orders)]

    def batch_step(self, i1: int, i2: int, twin: bool | None = None, values: bool = False) -> int:
        """Tiles of class pair (i1, i2) in one kernel call, so that one
        batch stays under BATCH_BYTES: sized for the twin's R tables when
        ``twin`` (by default on the CPU), else for the kernel's output:
        kernel 3's finished blocks when ``values`` (both of its parts),
        kernel 1's bra-contracted tiles otherwise."""
        m1, m2 = self.layout.metas[i1], self.layout.metas[i2]
        twin = self.device.type != "cuda" if twin is None else twin
        Lb, Lk = m1.la + m1.lb, m2.la + m2.lb
        S1, S2 = nhermite(Lb), nhermite(Lk)
        if twin:  # doubles per pair quartet of a tile
            per_pair = m1.a * m2.a * (2 * nhermite(Lb + Lk) + 2 * S1 * S2)
        elif values:
            per_pair = m1.A * m2.A
        else:
            per_pair = m1.A * m2.a * S2
        return max(1, BATCH_BYTES // (8 * m1.tile * m2.tile * per_pair))

    def batches(self, twin: bool | None = None, tasks=None, values: bool = False):
        """Every kernel call of one ``build`` (or over ``tasks``, a list of
        (i1, i2, ti, tj) in the form of the engine's own): (i1, i2, ti, tj)
        with the tile lists cut by ``batch_step``."""
        for i1, i2, ti, tj in self._tasks if tasks is None else tasks:
            step = self.batch_step(i1, i2, twin, values)
            for s in range(0, len(ti), step):
                yield i1, i2, ti[s : s + step], tj[s : s + step]

    def bra_batch(self, i1, i2, ti, tj, fn=bra_tiles, offsets=None) -> torch.Tensor:
        """Kernel 1 (or ``fn``) on one batch of tiles of class pair (i1, i2);
        ``offsets`` as ``bra_tiles`` takes them."""
        m1, m2 = self.layout.metas[i1], self.layout.metas[i2]
        E1, p1, P1 = self._padded[i1]
        _, p2, P2 = self._padded[i2]
        return fn(m1.la + m1.lb, m2.la + m2.lb, E1, p1, P1, p2, P2, ti, tj, m1.tile, m2.tile,
                  self._counts[i1], self._counts[i2], offsets)

    def _ket_layout(self, i: int, highl: bool) -> torch.Tensor:
        """Class i's E as kernel 3's template part (``highl`` False) or
        high-L part reads a class on its ket side (``ket_layout``), made
        once."""
        if (i, highl) not in self._ket_layouts:
            self._ket_layouts[i, highl] = ket_layout(self._padded[i][0], highl)
        return self._ket_layouts[i, highl]

    def values_batch(self, i1, i2, ti, tj, fn=tile_values, offsets=None) -> torch.Tensor:
        """Kernel 3 (or ``fn``, e.g. ``tile_values_plain``) on one batch of
        tiles of any class pair (i1, i2): the (nt, T1*A, T2*C) blocks;
        ``offsets`` as ``tile_values`` takes them."""
        m1, m2 = self.layout.metas[i1], self.layout.metas[i2]
        E1, p1, P1 = self._padded[i1]
        E2, p2, P2 = self._padded[i2]
        highl = max(m1.la + m1.lb, m2.la + m2.lb) > KERNEL_MAX_SIDE
        kw = ({"E1t": self._ket_layout(i1, highl), "E2t": self._ket_layout(i2, highl)}
              if fn is tile_values else {})
        return fn(m1.la + m1.lb, m2.la + m2.lb, E1, p1, P1, E2, p2, P2, ti, tj, m1.tile, m2.tile,
                  self._counts[i1], self._counts[i2], offsets, **kw)

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

    def _kernel_work(self, values: bool, select, pairs) -> tuple[float, float]:
        metas = self.layout.metas
        n = [c.n.cpu().numpy().astype(np.float64) for c in self._counts]
        tasks = [t for t in self._tasks if (pairs is None or t[:2] in pairs) and (
            select is None or select(metas[t[0]].la + metas[t[0]].lb, metas[t[1]].la + metas[t[1]].lb))]
        read = {i for i1, i2, _, _ in tasks for i in (i1, i2)}
        nbytes = sum(8.0 * (E.numel() + p.numel() + P.numel())
                     for i, (E, p, P) in enumerate(self._padded) if i in read)
        flops = 0.0
        for i1, i2, ti, tj in tasks:
            m1, m2 = metas[i1], metas[i2]
            Lb, Lk = m1.la + m1.lb, m2.la + m2.lb
            S2 = nhermite(Lk)
            per_pair = m1.A * m2.A if values else m1.A * m2.a * S2
            nbytes += 8.0 * len(ti) * per_pair * m1.tile * m2.tile
            rows = n[i1][ti[:, None] + np.arange(m1.tile)]  # (nt, T1) real bra primitive pairs
            cols = n[i2][tj[:, None] + np.arange(m2.tile)]
            flops += float((rows.sum(axis=1) * cols.sum(axis=1)).sum()) * _quartet_flops(
                Lb + Lk, nhermite(Lb), S2, m1.A)
            if values:  # the ket dot: each real ket primitive pair of a bra pair with any
                flops += float(((rows > 0).sum(axis=1) * cols.sum(axis=1)).sum()) * 2.0 * S2 * m1.A * m2.A
        return nbytes, flops

    def bra_kernel_work(self, select=None, pairs=None) -> tuple[float, float]:
        """(bytes, FLOPs) that kernel 1 must move and compute over one
        ``build()``: each class's E, p, P read once plus every output
        written once; ``_quartet_flops`` over the real primitive quartets
        (nonzero E on both sides) of every executed tile. ``select(Lb, Lk)``
        keeps only the class pairs for which it is true, and ``pairs``, a
        set of class pairs (i1, i2), only those (the classes they read are
        then the only inputs counted)."""
        return self._kernel_work(False, select, pairs)

    def values_kernel_work(self, select=None, pairs=None) -> tuple[float, float]:
        """(bytes, FLOPs) that kernel 3 must move and compute over the same
        tiles, as ``bra_kernel_work`` counts them: the inputs plus the
        finished (T1*A, T2*C) blocks, and ``_tile_flops``' model with both
        dots over the real primitive quartets (the ket dot once per real
        ket primitive pair of each bra pair that has a real one)."""
        return self._kernel_work(True, select, pairs)

    @functools.cached_property
    def sph_layout(self) -> SphericalPairLayout:
        """The spherical pair-space layout, built at first use."""
        return SphericalPairLayout(self.system, self.layout)

    def v2f_to_sph(self, V2f: torch.Tensor) -> torch.Tensor:
        """(Ms, Ms) spherical pair matrix from the mirrored Cartesian V2f:
        one two-sided product with the classes' kron blocks per class-pair
        block on and above the block diagonal (the rest stays zero; port of
        ``_v2f_to_sph``)."""
        sl, metas = self.sph_layout, self.layout.metas
        K = [torch.as_tensor(k, dtype=V2f.dtype, device=V2f.device) for k in sl.kmats]
        V2s = torch.zeros((sl.Ms, sl.Ms), dtype=V2f.dtype, device=V2f.device)
        for i1, m1 in enumerate(metas):
            r1, S1 = sl.bases[i1]
            for i2 in range(i1, len(metas)):
                m2 = metas[i2]
                r2, S2 = sl.bases[i2]
                blk = V2f[m1.row_base : m1.row_base + m1.npad * m1.A,
                          m2.row_base : m2.row_base + m2.npad * m2.A]
                blk = (blk.reshape(-1, m2.A) @ K[i2]).reshape(m1.npad, m1.A, m2.npad * S2)
                blk = torch.einsum("pAq,AS->pSq", blk, K[i1])
                V2s[r1 : r1 + m1.npad * S1, r2 : r2 + m2.npad * S2] = blk.reshape(m1.npad * S1, -1)
        return V2s

    def v2s_mirrored(self, V2: torch.Tensor) -> torch.Tensor:
        """The mirrored spherical pair matrix from the build's upper-valid
        V2 (port of ``_v2s_mirrored``): mirror V2 in place, project, mirror
        the projection (its diagonal class blocks are symmetric, so the
        elementwise mirror is exact)."""
        return mirror_inplace(self.v2f_to_sph(mirror_inplace(V2)))

    def _working_pairs(self, V2: torch.Tensor):
        """(mirrored pair matrix, AO-pair row map, n) in the system's
        working basis: the Cartesian V2 mirrored in place, or, for a
        spherical system, its projection."""
        if self.system.spherical:
            sl = self.sph_layout
            return self.v2s_mirrored(V2), torch.as_tensor(sl.pmap, device=V2.device), sl.ns
        return mirror_inplace(V2), torch.as_tensor(self.layout.pmap, device=V2.device), self.nao

    def finish_eri(self, V2: torch.Tensor) -> torch.Tensor:
        """(n, n, n, n) chemists' tensor (ij|kl) in the working basis (port
        of ``finish_eri``, ``qchem_rs_tpu/ops/eri_tiled.py:1043`` and
        ``:1089``): the row gathers of ``finish_terms`` without the
        exchange term, one AO row i at a time. Mirrors V2 in place; peak
        memory is V2 (and, when spherical, its projection) plus the
        output."""
        V2f, pmap, n = self._working_pairs(V2)
        pmap2 = pmap.reshape(n, n)
        e4 = torch.empty((n * n, n * n), dtype=V2.dtype, device=V2.device)
        for i in range(n):
            e4[i * n : (i + 1) * n] = V2f[pmap2[i]][:, pmap]
        return e4.reshape(n, n, n, n)

    def finish_terms(self, V2: torch.Tensor) -> torch.Tensor:
        """(n^2, n^2) operator terms[ij, kl] = (ij|kl) - 1/2 (ik|jl)
        (rhf.rs:58-62) in the working basis, one AO row i at a time: two
        gathers from the mirrored pair matrix give (ij|kl) for all j, k, l,
        and the exchange term is its j <-> k transpose. Mirrors V2 in
        place; peak memory is V2 (and, when spherical, its projection) plus
        the output."""
        V2f, pmap, n = self._working_pairs(V2)
        pmap2 = pmap.reshape(n, n)
        terms = torch.empty((n * n, n * n), dtype=V2.dtype, device=V2.device)
        for i in range(n):
            yb = V2f[pmap2[i]][:, pmap].reshape(n, n, n)  # [j, k, l] = (ij|kl)
            terms[i * n : (i + 1) * n] = (yb - 0.5 * yb.transpose(0, 1)).reshape(n, n * n)
        return terms
