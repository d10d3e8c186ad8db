"""Pair-space J/K Fock build: the no-n^4 scale path (port of
``qchem_rs_tpu/ops/fock_pair.py``).

Two pair-space matrices are built once per geometry, and every SCF pass
is two matrix-vector products over them:

- ``V2f[(ij), (kl)] = (ij|kl)``: the tiled engine's V2, mirrored in place.
  Coulomb is ``J[(ij)] = sum_(kl) V2f[(ij), (kl)] w_kl D[kl]`` with
  w = 2 - delta_kl, through kernel 2 (``ops/fock_matvec.matvec``), which
  reads only the block upper triangle of the symmetric V2f.
- ``W[(i, k), (jl)] = (ij|kl) + (il|kj)``: the exchange-ordered matrix,
  built from V2f by a loop over AO rows i (``build_w``). Exchange is one
  ``torch.mv``: ``K[(i, k)] = sum_(jl) W[(i, k), (jl)] wk_jl D[jl]`` with
  wk = 1 (j != l), 1/2 (j = l, where W counts the column twice). The JAX
  package computes this product outside any Pallas kernel too.

Lean mode keeps no W: K comes from V2f by the same row gathers, contracted
with the density at once (``exchange_lean``), in f64. It is chosen when
V2f and W together would pass the device budget: half of the card's
memory (half of the host's on the CPU), or ``QCHEM_TORCH_PAIR_BUDGET``
bytes when that is set. Naphthalene/cc-pVDZ needs 8.46 GB, so it runs
with W on an 80 GB card; ``lean=True`` forces lean mode.

A spherical system keeps the Cartesian pair matrices: ``jk`` maps its
density to the Cartesian basis and J and K back, two (nsph, ncart)
sandwiches (``qchem_rs_tpu/ops/fock_pair.py:344-358``), so kernel 2 still
reads the Cartesian V2f.

``PairSpaceShardedFockBuilder`` keeps each rank's column slabs of V2f and
W over a mesh (``parallel/mesh.py``).

Left out: the TPU's (hi, lo)-f32 split storage and its three programs and
``exchange_lean_split``.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from qchem_rs_tpu_torch.ops import fock_matvec
from qchem_rs_tpu_torch.ops.angular import ncart
from qchem_rs_tpu_torch.ops.eri_tiled import PairSpaceLayout, TiledEriEngine, mirror_inplace
from qchem_rs_tpu_torch.utils.system import MolecularSystem

#: bytes V2f and W may take together before the builder goes lean
BUDGET_ENV = "QCHEM_TORCH_PAIR_BUDGET"


def pair_row_ao(layout: PairSpaceLayout) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-V2-row AO indices (row_i, row_j), -1 on padding rows, and a
    ``dup`` mask: True on the redundant orientation rows of diagonal shell
    pairs (a shell paired with itself stores (a, b) and (b, a) as two rows
    holding the same AO pair; sums over all rows must count it once)."""
    M = layout.M
    row_i = np.full(M, -1, dtype=np.int64)
    row_j = np.full(M, -1, dtype=np.int64)
    dup = np.zeros(M, dtype=bool)
    for g, m in zip(layout.groups, layout.metas):
        ncA, ncB = ncart(g.la), ncart(g.lb)
        comp_dup = (np.arange(ncA)[:, None] < np.arange(ncB)[None, :]).reshape(-1)
        for k in range(g.npairs):
            rows = m.row_base + k * m.A + np.arange(ncA * ncB)
            row_i[rows] = np.repeat(g.ao_i[k] + np.arange(ncA), ncB)
            row_j[rows] = np.tile(g.ao_j[k] + np.arange(ncB), ncA)
            if g.i_shell[k] == g.j_shell[k]:
                dup[rows] = comp_dup
    return row_i, row_j, dup


def pair_weights(layout: PairSpaceLayout, nao: int, device):
    """Per-V2-row tensors on ``device``: the J weights w (2 - delta of the
    AO pair, 0 on padding and redundant rows), the K weights (1/2 where
    the pair is one AO twice, else 1; 0 on those rows), each row's flat
    AO-pair index i*nao + j and its AO indices (ci, cj)."""
    row_i, row_j, dup = pair_row_ao(layout)
    pad = row_i < 0
    ci = np.where(pad, 0, row_i)
    cj = np.where(pad, 0, row_j)
    dead = pad | dup
    f64 = lambda x: torch.as_tensor(x, dtype=torch.float64, device=device)  # noqa: E731
    i64 = lambda x: torch.as_tensor(x, dtype=torch.long, device=device)  # noqa: E731
    wj = f64(np.where(dead, 0.0, np.where(ci == cj, 1.0, 2.0)))
    wk = f64(np.where(dead, 0.0, np.where(ci == cj, 0.5, 1.0)))
    return wj, wk, i64(ci * nao + cj), i64(ci), i64(cj)


def build_w(V2f: torch.Tensor, pmap2: torch.Tensor, ci: torch.Tensor, cj: torch.Tensor) -> torch.Tensor:
    """Exchange-ordered W (nao^2, len(ci)) from the mirrored V2f,
    ``W[(i, k), m] = (i ci_m | k cj_m) + (i cj_m | k ci_m)`` for the AO
    pair (ci_m, cj_m) of V2 row m (every row, or the columns that ``ci``
    and ``cj`` select): per AO row i one row gather of V2f and two element
    gathers from it. No (M, M) temporary; peak memory is V2f,
    W and two (nao, M) index maps."""
    nao = pmap2.shape[0]
    cols_a = pmap2[:, cj]  # [k, m]: V2 row of (k, cj_m)
    cols_b = pmap2[:, ci]
    W = torch.empty((nao * nao, ci.shape[0]), dtype=V2f.dtype, device=V2f.device)
    for i in range(nao):
        y = V2f[pmap2[i]]  # [j, (kl)] = (ij|kl)
        W[i * nao : (i + 1) * nao] = y[ci, cols_a] + y[cj, cols_b]
    return W


def exchange_lean(V2f: torch.Tensor, pmap2: torch.Tensor, D: torch.Tensor) -> torch.Tensor:
    """K_ik = sum_jl (ij|kl) D_jl from the mirrored V2f with no W: the row
    gathers of ``build_w``, contracted with D as soon as they are made."""
    nao = pmap2.shape[0]
    pflat = pmap2.reshape(-1)
    K = torch.empty((nao, nao), dtype=V2f.dtype, device=V2f.device)
    for i in range(nao):
        yf = V2f[pmap2[i]][:, pflat].reshape(nao, nao, nao)  # [j, k, l] = (ij|kl)
        K[i] = torch.einsum("jkl,jl->k", yf, D)
    return K


def in_working_basis(system: MolecularSystem, D: torch.Tensor, cart_fn):
    """(J, K) of ``cart_fn`` (Cartesian D -> Cartesian (J, K)) for a
    density, or a stack of them, in the system's working basis: a
    spherical D goes through as ``sph_T D sph_T^T`` and J and K come back
    as ``sph_T^T X sph_T``."""
    if not system.spherical:
        return cart_fn(D)
    T = torch.as_tensor(system.sph_T, dtype=D.dtype, device=D.device)
    J, K = cart_fn(T @ D @ T.T)
    return T.T @ J @ T, T.T @ K @ T


def pair_budget(device: torch.device) -> float:
    """Bytes V2f and W may take together: ``QCHEM_TORCH_PAIR_BUDGET`` if
    set, else half of the card's memory (of the host's, on the CPU)."""
    env = os.environ.get(BUDGET_ENV)
    if env is not None:
        return float(env)
    if device.type == "cuda":
        return 0.5 * torch.cuda.get_device_properties(device).total_memory
    return 0.5 * os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")


class PairSpaceFockBuilder:
    """J/K backed by the pair-space matrices V2f and W.

        builder = PairSpaceFockBuilder(system, 1e-12, device="cuda")
        V2f, W = builder.prepare()   # V2 build, mirror, W (None when lean)
        J, K = builder.jk(D)         # kernel 2 and one torch.mv
    """

    def __init__(
        self,
        system: MolecularSystem,
        threshold: float = 1e-12,
        *,
        device,
        engine: TiledEriEngine | None = None,
        lean: bool | None = None,
    ):
        self.system = system
        self.device = torch.device(device)
        self.nao = nao = system.n_basis_cart()
        self.engine = engine or TiledEriEngine(system, threshold, device=self.device)
        layout = self.engine.layout
        self.M = M = layout.M
        if lean is None:
            lean = 8.0 * (M * M + nao * nao * M) > pair_budget(self.device)
        self.lean = lean
        # J takes w = 2 - delta (both orderings of the ket pair); W counts
        # the j = l columns twice, so K takes them at half weight
        self._wj, self._wk, self._pidx, self._ci, self._cj = pair_weights(layout, nao, self.device)
        self._pmap = torch.as_tensor(layout.pmap, device=self.device)
        self._prepared = None

    def prepare(self):
        """Build V2 (kernel 1), mirror it in place and build W: returns
        (V2f, W), W None in lean mode. Built once."""
        if self._prepared is None:
            V2f = mirror_inplace(self.engine.build())
            W = None if self.lean else build_w(V2f, self._pmap.reshape(self.nao, self.nao),
                                               self._ci, self._cj)
            self._prepared = (V2f, W)
        return self._prepared

    def density_vectors(self, D: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """The pair-space vectors (dJ, dK), each (M,), that V2f and W take
        for the density D."""
        d = D.reshape(-1)[self._pidx]
        return d * self._wj, d * self._wk

    def jk_cart(self, D: torch.Tensor, V2f: torch.Tensor, W: torch.Tensor | None):
        """J and K (nao, nao) of a symmetric density D on the builder's
        device: J through kernel 2 on the mirrored V2f, K as ``W @ dK`` or,
        in lean mode, by ``exchange_lean``."""
        nao = self.nao
        dJ, dK = self.density_vectors(D)
        Jp = fock_matvec.matvec(V2f, dJ)  # (M,)
        if W is None:
            K = exchange_lean(V2f, self._pmap.reshape(nao, nao), D)
        else:
            K = torch.mv(W, dK).reshape(nao, nao)
        return Jp[self._pmap].reshape(nao, nao), K

    def jk(self, D: torch.Tensor):
        """J and K of D in the system's working basis, building the pair
        matrices at first use; a spherical D goes through the Cartesian
        build as ``sph_T D sph_T^T``, and J and K come back as
        ``sph_T^T X sph_T``."""
        return in_working_basis(self.system, D, lambda Dc: self.jk_cart(Dc, *self.prepare()))


class ShardedPairJK:
    """J and K of a builder that holds this rank's columns of the pair
    matrices (the two sharded pair builders): its ``_partial_cart(D, V2f,
    W)`` gives this rank's (Jp (M,), K (nao^2,)) products of a Cartesian D,
    and one ``all_reduce`` each sums them over the ranks."""

    def _finish(self, Jp: torch.Tensor, K: torch.Tensor):
        nao = self.nao
        return Jp[self._pmap].reshape(nao, nao), K.reshape(nao, nao)

    def jk_cart(self, D: torch.Tensor, V2f: torch.Tensor, W: torch.Tensor):
        """J and K (nao, nao) of a symmetric Cartesian D from this rank's
        columns: local products, one ``all_reduce`` each."""
        Jp, K = self._partial_cart(D, V2f, W)
        return self._finish(self.mesh.all_reduce(Jp), self.mesh.all_reduce(K))

    def jk(self, D: torch.Tensor):
        """J and K of D in the system's working basis."""
        return in_working_basis(self.system, D, lambda Dc: self.jk_cart(Dc, *self.prepare()))

    def jk_partial(self, D: torch.Tensor):
        """This rank's share of J and K of D in the working basis, with no
        collective: over the ranks the shares add up to ``jk(D)``."""
        return in_working_basis(
            self.system, D, lambda Dc: self._finish(*self._partial_cart(Dc, *self.prepare())))


class PairSpaceShardedFockBuilder(ShardedPairJK, PairSpaceFockBuilder):
    """Pair-space J/K with the pair axis (M) sharded over a mesh (port of
    ``qchem_rs_tpu/ops/fock_pair.py:362-414``).

        builder = PairSpaceShardedFockBuilder(system, mesh, 1e-12)
        V2f_cols, W_cols = builder.prepare()   # (M, w), (nao^2, w), w ~ M/ndev
        J, K = builder.jk(D)                   # local products, one all_reduce each

    Each rank keeps its column slab of the mirrored V2f and its columns of
    W, ``cols`` = the rank's contiguous share of the M columns
    (``Mesh.share``: the first M % ndev ranks take one column more), so
    the pair matrices take about 1/ndev of the memory on each device.
    Every rank builds the whole V2 (kernel 1) and mirrors it, builds only
    its own W and V2f columns from it, and frees it: the build's peak is
    the whole (M, M) V2 on every device, as the JAX package's is on its
    default device (its "single-device high-water mark";
    ``ColumnShardedPairFockBuilder`` has none). J_local = V2f[:, cols] @
    dJ[cols] and K_local = W[:, cols] @ dK[cols] are plain ``torch.mv``
    products (kernel 2 reads a symmetric matrix, which a slab is not),
    then one ``all_reduce`` each; no collective needs equal slabs. No lean
    form: W's columns are kept (the lean trade is a one-device concern).
    The JAX package pads its pair counts to multiples of 8 so that its
    meshes divide M; the port's unequal shares need no padding and run on
    any mesh of at most M ranks.
    """

    def __init__(self, system: MolecularSystem, mesh, threshold: float = 1e-12, *,
                 engine: TiledEriEngine | None = None):
        super().__init__(system, threshold, device=mesh.device, engine=engine, lean=False)
        if mesh.size > self.M:
            raise ValueError(f"a mesh of {mesh.size} ranks is larger than the pair count M={self.M}")
        self.mesh = mesh
        #: this rank's columns of V2f and W
        self.cols = mesh.share(self.M)
        self._slab = None

    def _v2f(self) -> torch.Tensor:
        """The whole mirrored V2f (kernel 1), built anew."""
        return mirror_inplace(self.engine.build())

    def prepare(self):
        """Build V2 (kernel 1) and mirror it, then this rank's V2f and W
        columns; the whole V2f is freed. Returns (V2f[:, cols],
        W[:, cols]). Built once."""
        if self._prepared is None:
            V2f = self._v2f()
            W = build_w(V2f, self._pmap.reshape(self.nao, self.nao), self._ci[self.cols],
                        self._cj[self.cols])
            self._prepared = (V2f[:, self.cols].clone(), W)
            self._slab = None
        return self._prepared

    def _partial_cart(self, D: torch.Tensor, V2f: torch.Tensor, W: torch.Tensor):
        dJ, dK = self.density_vectors(D)
        return torch.mv(V2f, dJ[self.cols]), torch.mv(W, dK[self.cols])

    def v2f_slab(self) -> torch.Tensor:
        """This rank's V2f columns: the prepared ones, or, when only the MO
        transforms need them (``models/mp2.py``), the slab alone (no W),
        built once."""
        if self._prepared is not None:
            return self._prepared[0]
        if self._slab is None:
            self._slab = self._v2f()[:, self.cols].clone()
        return self._slab

    def mo_pair_contract(self, U: torch.Tensor) -> torch.Tensor:
        """U^T V2f U (m, m) for an (M, m) MO pair-distribution matrix
        (``models/mp2.py``): this rank's slab against U's rows of its
        columns, then one ``all_reduce``."""
        return self.mesh.all_reduce((U.T @ self.v2f_slab()) @ U[self.cols])
