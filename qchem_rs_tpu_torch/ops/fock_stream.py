"""Streaming integral-direct Fock build (port of
``qchem_rs_tpu/ops/fock_stream.py::StreamingFockBuilder``).

Nothing of size M^2 is stored: every J/K call computes all screened
tiles of the pair-space ERI matrix again (the engine's own task lists, in
batches sized for the values) and digests each batch of (nt, T1*A, T2*C)
tile values into J and K at once, for a stack of nd densities (nd = 2
digests both UHF spins against one pass). Kernel 3
(``eri_kernel.tile_values``, the counterpart of the JAX package's
``tile_vals_pallas``) gives the values of every class pair in one launch a
batch: its template part those with Lb, Lk <= 4, its high-L part the
f-shell class pairs.

Coverage: tasks hold class pairs i1 <= i2 and, within a class, the square
tiles on and above the diagonal. Every block is digested as itself and as
its transpose; a diagonal tile (ti == tj) is its own transpose, so it is
halved first. The total is then the contraction with the whole mirrored
V2, the pair-space formulas of ``ops/fock_pair.py``.

- J accumulates in pair space, ``Jp[rows] += V dJ[cols]`` and
  ``Jp[cols] += V^T dJ[rows]``: two batched products, each summed over
  the tiles of one tile row (resp. column) of the class pair by a product
  with the batch's one-hot tile-row matrix, then added to that class's
  contiguous slice of Jp.
- K is taken at shell-pair granularity rather than element by element. A
  tile block viewed as (T1, ncA, ncB, T2, ncC, ncD) holds (ij|kl) for the
  AOs i, j of its bra pairs and k, l of its ket pairs. With the orientation
  weights u folded in (0 on padding and redundant rows, 1/2 on i = j), the
  four orientations
      K[i, k] += V D[j, l]   K[i, l] += V D[j, k]
      K[j, k] += V D[i, l]   K[j, l] += V D[i, k]
  are each one batched contraction of the block with a gathered density
  block, summed over two component axes. Its (T1, ncA, T2, ncC) result is
  then summed over the bra pairs of each destination shell and the ket
  pairs of each destination shell by two products with one-hot shell
  matrices, which gives the batch's dense (shells x components)^2 block
  of K; that block goes to its AOs, each once. The transpose role of
  every block is K's transpose (D is symmetric), so K = K1 + K1^T at the
  end.

The reduction order is fixed: no atomics and no ``index_add_`` (whose
CUDA adds land in a run-to-run order). Products, gathers and the
elementwise adds of a batch's dense blocks, batch after batch, give the
same bits on every pass on the same inputs.

A spherical system's densities go through the Cartesian pass as
``sph_T D sph_T^T`` and J and K come back as ``sph_T^T X sph_T``
(``jk_stack``, ``qchem_rs_tpu/ops/fock_stream.py:313-320``).

Over a mesh (``mesh=``, ``parallel/mesh.py``; port of
``qchem_rs_tpu/ops/fock_stream.py:227-272``) each rank takes an equal
share, to one tile, of every class pair's screened tile list, digests it
into local Jp and K1 in the same fixed order, and one ``all_reduce`` each
sums them per ``jk_stack``. The JAX package pads the shares with sentinel
tiles of weight 0 because ``shard_map`` needs equal shapes; the port's
shares need none and are not padded (a repeated tile would be digested
twice). A rank view's ``jk_partial`` returns its share of J and K.

Left out: the JAX package's ``SEG_UNITS`` segments and sentinel tiles (they
keep each TPU program under its watchdog) and the df/pallas kernel switch.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from qchem_rs_tpu_torch.ops.angular import ncart
from qchem_rs_tpu_torch.ops.eri_tiled import TiledEriEngine
from qchem_rs_tpu_torch.ops.fock_pair import in_working_basis, pair_weights
from qchem_rs_tpu_torch.utils.system import MolecularSystem


class StreamingFockBuilder:
    """Integral-direct J/K: recompute the screened tiles at every call and
    digest them at once.

        builder = StreamingFockBuilder(system, 1e-12, device="cuda")
        J, K = builder.jk(D)                 # D (n, n), working basis
        Js, Ks = builder.jk_stack(Ds)        # Ds (nd, n, n)

    ``mesh`` (a ``parallel.mesh.Mesh``, whose device the builder runs on)
    shares the tile lists over its ranks.
    """

    def __init__(self, system: MolecularSystem, threshold: float = 1e-12, *, device=None,
                 engine: TiledEriEngine | None = None, mesh=None):
        self.system = system
        self.mesh = mesh
        if mesh is not None and device is not None and torch.device(device) != mesh.device:
            raise ValueError(f"device {device} is not the mesh's {mesh.device}")
        dev = mesh.device if mesh is not None else torch.device(device)
        self.nao = nao = system.n_basis_cart()
        self.engine = eng = engine or TiledEriEngine(system, threshold, device=dev)
        layout = eng.layout
        self.M = layout.M
        i64 = lambda x: torch.as_tensor(x, dtype=torch.long, device=dev)  # noqa: E731
        # the J ket weight 2 - delta, and the K orientation weight u
        self._wj, self._uk, self._pidx, _, _ = pair_weights(layout, nao, dev)
        self._pmap = i64(layout.pmap)
        # per class: each padded pair's first AO on either side (padding
        # pairs point at AO 0 and carry weight 0)
        self._ao = []
        for g, m in zip(layout.groups, layout.metas):
            ai = np.zeros(m.npad, dtype=np.int64)
            aj = np.zeros(m.npad, dtype=np.int64)
            ai[: g.npairs], aj[: g.npairs] = g.ao_i, g.ao_j
            self._ao.append((i64(ai), i64(aj)))
        # per class: the rank of each padded pair's two shells among the
        # shells of their angular momentum (padding pairs take rank 0 and
        # weight 0), and per angular momentum its shells' AOs
        rank = {}
        self._aos = {}
        for l, cls in system.shell_classes.items():
            rank[l] = np.zeros(nao, dtype=np.int64)
            rank[l][cls.ao_offsets] = np.arange(cls.nshells)
            self._aos[l] = i64((cls.ao_offsets[:, None] + np.arange(ncart(l))).reshape(-1))
        self._nshells = {l: cls.nshells for l, cls in system.shell_classes.items()}
        self._shell = []
        for g, m in zip(layout.groups, layout.metas):
            si = np.zeros(m.npad, dtype=np.int64)
            sj = np.zeros(m.npad, dtype=np.int64)
            si[: g.npairs], sj[: g.npairs] = rank[g.la][g.ao_i], rank[g.lb][g.ao_j]
            self._shell.append((i64(si), i64(sj)))
        metas = layout.metas
        for i1, i2, ti, tj in eng._tasks:
            if i1 == i2 and (metas[i1].tile != metas[i2].tile or (tj < ti).any()):
                raise RuntimeError("same-class tiles must be square and on or above the diagonal")
        tasks = eng._tasks
        if mesh is not None:  # this rank's share of each class pair's tiles
            shares = [mesh.share(len(ti)) for _, _, ti, _ in tasks]
            tasks = [(i1, i2, ti[s], tj[s]) for (i1, i2, ti, tj), s in zip(tasks, shares)]
        # batches sized for kernel 3's output (the host spends about 2 ms on
        # a batch, so fewer and larger batches are faster); over a mesh,
        # this rank's share
        self._plan(list(eng.batches(tasks=tasks, values=True)))

    def _plan(self, batches: list) -> None:
        """Take ``batches``, (i1, i2, ti, tj) as ``TiledEriEngine.batches``
        cuts them, as the kernel calls of every pass."""
        dev = self.engine.device
        #: every kernel call of one pass: (i1, i2, ti, tj)
        self.batches = batches
        # the tile offsets of each batch on the device, copied once: a copy
        # from host memory at every pass would make the host wait for the
        # device three times a batch
        i64 = lambda x: torch.as_tensor(x, dtype=torch.long, device=dev)  # noqa: E731
        i32 = lambda x: torch.as_tensor(x, dtype=torch.int32, device=dev)  # noqa: E731
        self._offsets = [(i64(ti), i64(tj), (i32(ti), i32(tj))) for _, _, ti, tj in batches]

    def tile_values(self, k: int) -> torch.Tensor:
        """The (nt, T1*A, T2*C) V2 blocks of batch ``k`` (kernel 3)."""
        i1, i2, ti, tj = self.batches[k]
        return self.engine.values_batch(i1, i2, ti, tj, offsets=self._offsets[k][2])

    def _digest(self, i1, i2, ti_d, tj_d, vals, D, dJ, Jp, K1) -> None:
        """Add one batch's tile values (halved in place on diagonal tiles
        and weighted in place) into Jp (M, nd) and K1 (nd, nao, nao), in
        a fixed order."""
        metas = self.engine.layout.metas
        m1, m2 = metas[i1], metas[i2]
        nt, nr, nc = vals.shape
        nd = D.shape[0]
        dev, f64 = vals.device, vals.dtype
        T1, T2 = m1.tile, m2.tile
        if i1 == i2:
            vals *= torch.where(ti_d == tj_d, 0.5, 1.0).to(f64)[:, None, None]
        rows = m1.row_base + ti_d[:, None] * m1.A + torch.arange(nr, device=dev)  # (nt, nr)
        cols = m2.row_base + tj_d[:, None] * m2.A + torch.arange(nc, device=dev)
        # J, both roles: each tile's product, summed over the tiles of each
        # tile row (column) of the class pair, into the class's slice of Jp
        for m, t_d, T, prod in ((m1, ti_d, T1, torch.bmm(vals, dJ[cols])),
                                (m2, tj_d, T2, torch.bmm(vals.transpose(1, 2), dJ[rows]))):
            onehot = F.one_hot(t_d // T, m.npad // T).to(f64)  # (nt, tiles of the class)
            Jp[m.row_base : m.row_base + m.npad * m.A] += (onehot.T @ prod.reshape(nt, -1)).view(
                -1, nd)
        # K, role 1 at shell-pair granularity
        vals *= self._uk[rows][:, :, None]
        vals *= self._uk[cols][:, None, :]
        ncA, ncB, ncC, ncD = ncart(m1.la), ncart(m1.lb), ncart(m2.la), ncart(m2.lb)
        V = vals.view(nt, T1, ncA, ncB, T2, ncC, ncD)
        ai, aj = self._ao[i1]
        ak, al = self._ao[i2]
        p1 = ti_d[:, None] + torch.arange(T1, device=dev)  # (nt, T1) bra pairs
        p2 = tj_d[:, None] + torch.arange(T2, device=dev)
        I = ai[p1][:, :, None] + torch.arange(ncA, device=dev)  # (nt, T1, ncA)
        J = aj[p1][:, :, None] + torch.arange(ncB, device=dev)
        Kk = ak[p2][:, :, None] + torch.arange(ncC, device=dev)  # (nt, T2, ncC)
        L = al[p2][:, :, None] + torch.arange(ncD, device=dev)
        # one-hot shell matrices (nt, T, shells of l) of each pair's shells
        (si, sj), (sk, sl) = self._shell[i1], self._shell[i2]
        shells = {"i": (si[p1], m1.la), "j": (sj[p1], m1.lb), "k": (sk[p2], m2.la),
                  "l": (sl[p2], m2.lb)}
        onehot = {x: (F.one_hot(s, self._nshells[l]).to(f64), l) for x, (s, l) in shells.items()}

        def block(X, Y):  # D[s, X[n, x, u], Y[n, y, v]] -> (nd, nt, T1, u, T2, v)
            return D[:, X[:, :, :, None, None], Y[:, None, None, :, :]]

        def add(out, r, c):  # K1[s, r-AO of (n, x, u), c-AO of (n, y, v)] += out[s, n, x, u, y, v]
            (orow, lr), (ocol, lc) = onehot[r], onehot[c]
            z = torch.einsum("snxuyv,nxi->sniuyv", out, orow)
            kb = torch.einsum("sniuyv,nyk->siukv", z, ocol)  # (nd, shells, u, shells, v)
            R, C = self._aos[lr], self._aos[lc]
            K1[:, R[:, None], C[None, :]] += kb.reshape(nd, R.numel(), C.numel())

        add(torch.einsum("nxabycd,snxbyd->snxayc", V, block(J, L)), "i", "k")
        add(torch.einsum("nxabycd,snxbyc->snxayd", V, block(J, Kk)), "i", "l")
        add(torch.einsum("nxabycd,snxayd->snxbyc", V, block(I, L)), "j", "k")
        add(torch.einsum("nxabycd,snxayc->snxbyd", V, block(I, Kk)), "j", "l")

    def _local_pass(self, D: torch.Tensor):
        """(Jp (M, nd), K1 (nd, nao, nao)) of this builder's batches for a
        stack of symmetric Cartesian densities D (nd, nao, nao)."""
        nd, nao = D.shape[0], self.nao
        dJ = (D.reshape(nd, -1)[:, self._pidx] * self._wj).T.contiguous()  # (M, nd)
        Jp = torch.zeros((self.M, nd), dtype=D.dtype, device=D.device)
        K1 = torch.zeros((nd, nao, nao), dtype=D.dtype, device=D.device)
        for k, ((i1, i2, _, _), (ti_d, tj_d, _)) in enumerate(zip(self.batches, self._offsets)):
            self._digest(i1, i2, ti_d, tj_d, self.tile_values(k), D, dJ, Jp, K1)
        return Jp, K1

    def _finish(self, Jp: torch.Tensor, K1: torch.Tensor):
        nd, nao = K1.shape[0], self.nao
        return Jp[self._pmap].T.reshape(nd, nao, nao), K1 + K1.transpose(1, 2)

    def jk_stack_cart(self, D: torch.Tensor):
        """J and K stacks (nd, nao, nao) of a stack of symmetric densities
        (nd, nao, nao): one pass of the kernels over every screened tile (over
        a mesh, this rank's share, then one ``all_reduce`` of Jp and one of
        K1)."""
        Jp, K1 = self._local_pass(D)
        if self.mesh is not None:
            self.mesh.all_reduce(Jp)
            self.mesh.all_reduce(K1)
        return self._finish(Jp, K1)

    def jk_stack(self, D: torch.Tensor):
        """J and K stacks (nd, n, n) of a stack of symmetric densities in
        the system's working basis: spherical densities are mapped to the
        Cartesian basis and J and K back, around one Cartesian pass."""
        return in_working_basis(self.system, D, self.jk_stack_cart)

    def jk(self, D: torch.Tensor):
        """J and K (n, n) of one symmetric density in the working basis."""
        J, K = self.jk_stack(D[None])
        return J[0], K[0]

    def jk_partial(self, D: torch.Tensor):
        """This rank's share of J and K of a symmetric density (n, n), or
        of a stack of them (nd, n, n), in the working basis, with no
        collective: over the ranks of a mesh the shares add up to ``jk(D)``
        (``jk_stack(D)``)."""
        J, K = in_working_basis(self.system, D if D.dim() == 3 else D[None],
                                lambda Dc: self._finish(*self._local_pass(Dc)))
        return (J, K) if D.dim() == 3 else (J[0], K[0])
