"""Column-sharded V2 build: the pair-space Fock path with no device holding
the whole (M, M) matrix (port of ``qchem_rs_tpu/parallel/v2_sharded.py``).

``ops/fock_pair.PairSpaceShardedFockBuilder`` shards the pair matrices for
the SCF passes, but every rank still builds the whole V2 first. Here:

- Each rank owns a set of ket tile-columns (whole columns of a class's
  pair-tile grid), balanced over the ranks by their Schwarz-screened tile
  cost (longest processing time first), and builds only its slab
  ``V2f[:, cols(rank)]``. Every ordered class pair (i1, i2) runs, in both
  orientations, with the tiles below the diagonal of a class included:
  about twice the integral work of one build, for 1/ndev of the memory
  and of the time on each device.
- Each tile goes through kernel 1 (``engine.bra_batch``), then
  ``ket_contract``, and is written into the local slab at rows
  ``row_base + ti*A`` and the tile-column's local columns. The port's own
  tile sizes (``metas[i].tile``) set the grid.
- The slab keeps a permuted column layout: the rank's tile-columns, one
  after another. ``colperm`` maps each local slot to its V2 column (-1 on
  padding), ``permidx`` each V2 column to its place in the ranks'
  slabs laid side by side. The W build and the J/K products go through
  them, so no collective ever reorders columns.
- W is built sharded too: per AO row, the ranks' (nao, Mcap) row slabs
  are all-gathered (``all_gather`` needs equal shapes, so every slab has
  ``Mcap`` columns), reordered through ``permidx``, and only the local W
  columns are taken.
- J and K are local products, then one ``all_reduce`` each.

Padding columns carry weight 0 in every product, are never written, and
no permutation points at them. The JAX package also pads each rank's
tile list to one length by repeating its last tile, and aims a rank with
no tile of a class pair at a scratch strip past the slab, because
``shard_map`` needs equal shapes; the port's ranks launch only their own
tiles, so it needs neither. Its ``SEG_UNITS`` segments and df/pallas
switch are TPU machinery and are left out.

A rank view (``parallel/mesh.rank_view``) builds its slab alone; its W
needs the other ranks' slabs, which ``prepare_rank_views`` supplies for
every view of one mesh size in one process.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from qchem_rs_tpu_torch.ops.eri_kernel import ket_contract
from qchem_rs_tpu_torch.ops.eri_tiled import TiledEriEngine, _tile_flops
from qchem_rs_tpu_torch.ops.fock_pair import ShardedPairJK, pair_row_ao
from qchem_rs_tpu_torch.utils.system import MolecularSystem


@dataclasses.dataclass
class _TileColumn:
    """One ket tile-column: ``tile`` consecutive pairs of one class."""

    cls: int  # ket class index
    tj: int  # first pair (a multiple of the class's tile)
    width: int  # V2 columns: tile * A
    base: int  # first V2 column: row_base + tj * A
    cost: float = 0.0
    rank: int = -1
    local: int = -1  # first local column on its rank


def _tile_max(bounds, m) -> np.ndarray:
    """Per tile of a class, the largest Schwarz bound of its pairs (ones
    when unscreened)."""
    if bounds is None:
        return np.ones(m.npad // m.tile)
    b = np.zeros(m.npad)
    b[: m.npairs] = bounds
    return b.reshape(-1, m.tile).max(axis=1)


class ColumnShardedPairFockBuilder(ShardedPairJK):
    """Pair-space J/K over a mesh with the V2 build itself sharded.

        b = ColumnShardedPairFockBuilder(system, mesh, 1e-12)
        V2f, W = b.prepare()    # this rank's (M, Mcap) and (nao^2, Mcap)
        J, K = b.jk(D)          # local products, one all_reduce each

    The column layout of V2f and W is this rank's permuted one; use this
    builder's own consumers (``jk``, ``jk_partial``, ``mo_pair_contract``;
    a rank view's ``jk_partial`` once ``prepare_rank_views`` has prepared
    it)."""

    def __init__(self, system: MolecularSystem, mesh, threshold: float = 1e-12, *,
                 engine: TiledEriEngine | None = None):
        self.system = system
        self.mesh = mesh
        self.device = dev = mesh.device
        self.nao = nao = system.n_basis_cart()
        self.engine = eng = engine or TiledEriEngine(system, threshold, device=dev)
        layout = eng.layout
        self.M = layout.M
        metas = layout.metas
        bounds = eng.bounds
        thr = eng.threshold
        ndev = mesh.size
        tmax = [_tile_max(None if bounds is None else bounds[i], m) for i, m in enumerate(metas)]

        # host: the ket tile-columns and their screened tile costs
        tcols = [_TileColumn(cls=i2, tj=j * m2.tile, width=m2.tile * m2.A,
                             base=m2.row_base + j * m2.tile * m2.A)
                 for i2, m2 in enumerate(metas) for j in range(m2.npad // m2.tile)
                 if j * m2.tile < m2.npairs]
        for tc in tcols:
            jb = tmax[tc.cls][tc.tj // metas[tc.cls].tile]
            for i1, m1 in enumerate(metas):
                kept = int(np.sum(tmax[i1] * jb > thr)) if bounds is not None else len(tmax[i1])
                tc.cost += kept * _tile_flops(m1, metas[tc.cls], m1.tile, metas[tc.cls].tile)
        # longest processing time first: each column to the least loaded rank
        load = np.zeros(ndev)
        width = np.zeros(ndev, dtype=np.int64)
        for tc in sorted(tcols, key=lambda t: -t.cost):
            tc.rank = int(np.argmin(load))
            load[tc.rank] += tc.cost
            width[tc.rank] += tc.width
        #: columns of every rank's slab
        self.Mcap = int(width.max()) if tcols else 0
        #: the ranks' screened tile costs (analytic FLOPs)
        self.loads = load
        cursor = np.zeros(ndev, dtype=np.int64)
        for tc in tcols:  # (class, tj) order within each rank
            tc.local = int(cursor[tc.rank])
            cursor[tc.rank] += tc.width
        self._tcols = tcols

        #: (ndev, Mcap): the V2 column of every rank's local slot, -1 on padding
        self.colperm = np.full((ndev, self.Mcap), -1, dtype=np.int64)
        for tc in tcols:
            self.colperm[tc.rank, tc.local : tc.local + tc.width] = tc.base + np.arange(tc.width)
        #: (M,): each V2 column's place in the ranks' slabs side by side
        self.permidx = np.full(self.M, -1, dtype=np.int64)
        for d in range(ndev):
            live = np.flatnonzero(self.colperm[d] >= 0)
            self.permidx[self.colperm[d, live]] = d * self.Mcap + live

        # weights and index maps of this rank's slots (padding: weight 0)
        row_i, row_j, dup = pair_row_ao(layout)
        pad = row_i < 0
        ci = np.where(pad, 0, row_i)
        cj = np.where(pad, 0, row_j)
        dead = pad | dup
        wj = np.where(dead, 0.0, np.where(ci == cj, 1.0, 2.0))
        wk = np.where(dead, 0.0, np.where(ci == cj, 0.5, 1.0))
        own = self.colperm[mesh.rank]
        padslot = own < 0
        cp = np.where(padslot, 0, own)
        f64 = lambda x: torch.as_tensor(x, dtype=torch.float64, device=dev)  # noqa: E731
        i64 = lambda x: torch.as_tensor(x, dtype=torch.long, device=dev)  # noqa: E731
        self._cp = i64(cp)
        self._live = f64(~padslot)
        self._pidx_l = i64(np.where(padslot, 0, (ci * nao + cj)[cp]))  # also W's first column take
        self._wj_l = f64(np.where(padslot, 0.0, wj[cp]))
        self._wk_l = f64(np.where(padslot, 0.0, wk[cp]))
        self._colB_l = i64(np.where(padslot, 0, (cj * nao + ci)[cp]))
        self._pmap = i64(layout.pmap)
        self._pmap2 = self._pmap.reshape(nao, nao)
        if (self.permidx[layout.pmap] < 0).any():
            raise RuntimeError("an AO pair's V2 column is owned by no rank")
        self._permsel = i64(self.permidx[layout.pmap])  # (nao^2,)

        #: this rank's tiles, per ordered class pair: (i1, i2, ti, tj, cloc)
        self.tasks = self._plan_tasks(metas, tmax, bounds is not None, thr)
        self._prepared = None
        self._slab = None

    def _plan_tasks(self, metas, tmax, screened: bool, thr: float):
        """Every ordered class pair's kept (bra tile, ket tile) of this
        rank's tile-columns, both orientations and the tiles below a
        class's diagonal included: (i1, i2, ti, tj, cloc) with host arrays
        of bra and ket pair offsets and local columns."""
        mine = [tc for tc in self._tcols if tc.rank == self.mesh.rank]
        tasks = []
        for i1, m1 in enumerate(metas):
            nb = -(-m1.npairs // m1.tile)  # bra tiles holding a real pair
            for i2 in range(len(metas)):
                ti, tj, cloc = [], [], []
                for tc in (t for t in mine if t.cls == i2):
                    jb = tmax[i2][tc.tj // metas[i2].tile]
                    keep = np.arange(nb)
                    if screened:
                        keep = keep[tmax[i1][:nb] * jb > thr]
                    ti.append(keep * m1.tile)
                    tj.append(np.full(len(keep), tc.tj))
                    cloc.append(np.full(len(keep), tc.local))
                if ti and sum(map(len, ti)):
                    tasks.append((i1, i2, np.concatenate(ti), np.concatenate(tj),
                                  np.concatenate(cloc)))
        return tasks

    # ----------------------------------------------------------------- build

    def build(self) -> torch.Tensor:
        """This rank's slab (M, Mcap) of the mirrored V2f, in its permuted
        column layout: every one of its tiles through kernel 1 and the ket
        contraction, written once. Padding columns stay zero."""
        eng, metas = self.engine, self.engine.layout.metas
        dev = self.device
        slab = torch.zeros((self.M, self.Mcap), dtype=torch.float64, device=dev)
        for i1, i2, ti, tj, cloc in self.tasks:
            m1, m2 = metas[i1], metas[i2]
            step = eng.batch_step(i1, i2)
            r = np.arange(m1.tile * m1.A)
            c = np.arange(m2.tile * m2.A)
            for s in range(0, len(ti), step):
                bti, btj = ti[s : s + step], tj[s : s + step]
                vals = ket_contract(eng.bra_batch(i1, i2, bti, btj), eng._padded[i2][0], btj,
                                    m2.tile)
                rows = m1.row_base + bti[:, None, None] * m1.A + r[None, :, None]
                cols = cloc[s : s + step][:, None, None] + c[None, None, :]
                slab[torch.as_tensor(rows, device=dev), torch.as_tensor(cols, device=dev)] = vals
        return slab

    def _build_w(self, slab: torch.Tensor, gather=None) -> torch.Tensor:
        """This rank's W columns (nao^2, Mcap): per AO row i, the ranks'
        (nao, Mcap) row slabs gathered side by side (``gather(rows)``, by
        default the mesh's ``all_gather`` of ``slab[rows]``), reordered
        through ``permidx`` to (ij|kl) for every j and (kl), and the two
        exchange column takes of this rank's slots."""
        nao = self.nao
        if gather is None:
            gather = lambda rows: self.mesh.all_gather(slab[rows], dim=1)  # noqa: E731
        W = torch.empty((nao * nao, self.Mcap), dtype=slab.dtype, device=slab.device)
        for i in range(nao):
            yf = gather(self._pmap2[i])[:, self._permsel]  # [j, (k, l)] = (ij|kl)
            yt = yf.reshape(nao, nao, nao).transpose(0, 1).reshape(nao, nao * nao)  # [k, (j, l)]
            W[i * nao : (i + 1) * nao] = yt[:, self._pidx_l] + yt[:, self._colB_l]
        return W

    def prepare(self):
        """(slab, W columns) of this rank, built once."""
        if self._prepared is None:
            slab = self.v2f_slab()
            self._prepared = (slab, self._build_w(slab))
            self._slab = None
        return self._prepared

    # ------------------------------------------------------------------- J/K

    def _partial_cart(self, D: torch.Tensor, slab: torch.Tensor, W: torch.Tensor):
        d = D.reshape(-1)[self._pidx_l]  # (Mcap,)
        return torch.mv(slab, d * self._wj_l), torch.mv(W, d * self._wk_l)

    # ------------------------------------------------------- MO contractions

    def v2f_slab(self) -> torch.Tensor:
        """The prepared slab, or, when only the MO transforms need it
        (``models/mp2.py``), the slab alone (no W), built once."""
        if self._prepared is not None:
            return self._prepared[0]
        if self._slab is None:
            self._slab = self.build()
        return self._slab

    def mo_pair_contract(self, U: torch.Tensor) -> torch.Tensor:
        """U^T V2f U (m, m) for an (M, m) MO pair-distribution matrix in V2
        row order: this rank's slab against U's rows of its slots (zero on
        padding), then one ``all_reduce``."""
        Up = U[self._cp] * self._live[:, None]
        return self.mesh.all_reduce((U.T @ self.v2f_slab()) @ Up)


def prepare_rank_views(builders: list) -> None:
    """Prepare every rank view of one mesh size in this process: each
    view's slab, then each view's W with the all-gather served from the
    views' slabs in rank order."""
    if [b.mesh.rank for b in builders] != list(range(len(builders))):
        raise ValueError("pass the views of every rank, in rank order")
    slabs = [b.v2f_slab() for b in builders]
    for b, slab in zip(builders, slabs):
        b._prepared = (slab, b._build_w(slab, lambda rows: torch.cat([s[rows] for s in slabs], 1)))
        b._slab = None
