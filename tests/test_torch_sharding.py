"""Port parity, the sharded Fock builders on the CPU: the port's
``ShardedFockBuilder``, ``PairSpaceShardedFockBuilder`` and
``ColumnShardedPairFockBuilder`` against the JAX builders of the same name
on the 8-way virtual CPU mesh (``data_mesh(8, axis="q")``). The port's
side runs as rank views of 1, 3 and 8 ranks in one process, their
``jk_partial`` shares added in rank order. ``PairSpaceShardedFockBuilder``
gives each rank a contiguous share of the pair count M (37 for
water/STO-3G and 228 for methane/3-21G in the port's layout, which 3 and
8 do not divide) and raises only for a mesh of more than M ranks."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qchem_rs_tpu.ops.fock_pair import PairSpaceShardedFockBuilder as JaxPairSharded
from qchem_rs_tpu.parallel.fock_sharded import ShardedFockBuilder as JaxSharded
from qchem_rs_tpu.parallel.mesh import data_mesh as jax_data_mesh
from qchem_rs_tpu.parallel.v2_sharded import ColumnShardedPairFockBuilder as JaxColumnSharded
from qchem_rs_tpu.utils.basis import BasisSet as JaxBasisSet
from qchem_rs_tpu.utils.system import MolecularSystem as JaxSystem
from qchem_rs_tpu_torch import BasisSet, HartreeFockConfig, MolecularSystem
from qchem_rs_tpu_torch import restricted_hartree_fock, unrestricted_hartree_fock
from qchem_rs_tpu_torch.models import cc, cis, mp2
from qchem_rs_tpu_torch.ops.eri_tiled import TiledEriEngine, mirror_inplace
from qchem_rs_tpu_torch.ops.fock_pair import PairSpaceShardedFockBuilder
from qchem_rs_tpu_torch.parallel.fock_sharded import ShardedFockBuilder
from qchem_rs_tpu_torch.parallel.mesh import data_mesh, rank_view
from qchem_rs_tpu_torch.parallel.v2_sharded import ColumnShardedPairFockBuilder, prepare_rank_views
from tests.torch_threads import one_torch_thread  # noqa: F401

DATA = os.path.join(os.path.dirname(__file__), "..", "data")
THRESHOLD = 1e-12
SYSTEMS = {"water-sto3g": ("water", "STO-3G"), "methane-321g": ("methane", "3-21G")}
BUILDERS = {
    "stream": (ShardedFockBuilder, JaxSharded),
    "pair": (PairSpaceShardedFockBuilder, JaxPairSharded),
    "column": (ColumnShardedPairFockBuilder, JaxColumnSharded),
}


def _paths(name):
    mol, basis = SYSTEMS[name]
    return os.path.join(DATA, "mol", f"{mol}.json"), os.path.join(DATA, "basis", f"{basis}.json")


def _system(name):
    mpath, bpath = _paths(name)
    return MolecularSystem.load(mpath, BasisSet.load(bpath))


def _density(n, seed=7):
    D = np.random.default_rng(seed).standard_normal((n, n))
    return D + D.T


@pytest.fixture(scope="module")
def jax_jk():
    """J and K of the JAX builder ``kind`` on the 8-way mesh for a random
    symmetric density of system ``name``, computed once per pair."""
    done = {}

    def get(kind, name):
        if (kind, name) not in done:
            mpath, bpath = _paths(name)
            jsys = JaxSystem.load(mpath, JaxBasisSet.load(bpath))
            D = _density(jsys.n_basis())
            builder = BUILDERS[kind][1](jsys, jax_data_mesh(8, axis="q"), axis="q",
                                        threshold=THRESHOLD)
            J, K = builder.jk(jnp.asarray(D))
            done[kind, name] = (D, np.asarray(J), np.asarray(K))
        return done[kind, name]

    return get


def _views(cls, system, size):
    """The builder's rank views of a mesh of ``size`` (the one-device mesh
    for 1), sharing one engine; column views are prepared together."""
    engine = TiledEriEngine(system, THRESHOLD, device="cpu")
    meshes = [data_mesh(device="cpu")] if size == 1 else [rank_view(size, r, "cpu")
                                                          for r in range(size)]
    views = [cls(system, mesh, THRESHOLD, engine=engine) for mesh in meshes]
    if cls is ColumnShardedPairFockBuilder and size > 1:
        prepare_rank_views(views)
    return views


def _summed(views, D):
    """The views' ``jk_partial`` shares of D, added in rank order."""
    J = K = 0.0
    for view in views:
        Jr, Kr = view.jk_partial(torch.tensor(D))
        J, K = J + Jr.numpy(), K + Kr.numpy()
    return J, K


PARITY = [(kind, name, size) for kind in ("stream", "column") for name in ("water-sto3g",)
          for size in (1, 3, 8)]
PARITY += [("pair", "water-sto3g", size) for size in (1, 3, 8)] + [("pair", "methane-321g", 8)]


@pytest.mark.parametrize("kind,name,size", PARITY, ids=[f"{k}-{n}-{s}" for k, n, s in PARITY])
def test_rank_views_sum_to_the_jax_jk(jax_jk, kind, name, size):
    D, J_ref, K_ref = jax_jk(kind, name)
    J, K = _summed(_views(BUILDERS[kind][0], _system(name), size), D)
    assert np.abs(J - J_ref).max() <= 1e-11
    assert np.abs(K - K_ref).max() <= 1e-11


@pytest.mark.parametrize("kind", ["stream", "column"])
def test_one_device_mesh_jk_matches_jax(jax_jk, kind):
    # the one-device mesh's jk: collectives are the identity
    D, J_ref, K_ref = jax_jk(kind, "water-sto3g")
    builder = BUILDERS[kind][0](_system("water-sto3g"), data_mesh(device="cpu"), THRESHOLD)
    J, K = builder.jk(torch.tensor(D))
    assert np.abs(J.numpy() - J_ref).max() <= 1e-11
    assert np.abs(K.numpy() - K_ref).max() <= 1e-11


@pytest.mark.parametrize("kind", sorted(BUILDERS))
def test_rank_view_jk_raises(kind):
    # a rank view must never stand in for a real collective
    name = "methane-321g" if kind == "pair" else "water-sto3g"  # M of 228 and 37
    builder = BUILDERS[kind][0](_system(name), rank_view(2, 0, "cpu"), THRESHOLD)
    with pytest.raises(RuntimeError, match="collective|prepare_rank_views"):
        builder.jk(torch.eye(builder.system.n_basis(), dtype=torch.float64))


@pytest.mark.parametrize("name,size", [("water-sto3g", 38)])
def test_pair_sharded_needs_the_mesh_size_to_divide_m(name, size):
    # the shares are unequal where the mesh size does not divide M (the
    # PARITY cases), but every rank needs at least one of the M columns
    with pytest.raises(ValueError, match="larger than the pair count M=37"):
        PairSpaceShardedFockBuilder(_system(name), rank_view(size, 0, "cpu"), THRESHOLD)


@pytest.mark.parametrize("size", [3, 8])
def test_column_plan_and_slabs(size):
    """The column planner's invariants (every V2 column owned once,
    permidx inverting colperm, zero weight on padding) and its slabs,
    placed through colperm, equal to the mirrored V2f; padding columns
    are never written (at 8 ranks some ranks own no column)."""
    system = _system("water-sto3g")
    views = _views(ColumnShardedPairFockBuilder, system, size)
    cp = views[0].colperm
    live = cp[cp >= 0]
    assert len(np.unique(live)) == len(live) == views[0].M
    for d, view in enumerate(views):
        slots = np.flatnonzero(cp[d] >= 0)
        assert (view.permidx[cp[d, slots]] == d * view.Mcap + slots).all()
        assert (view._wj_l.numpy()[cp[d] < 0] == 0).all()
    V2f = mirror_inplace(views[0].engine.build()).numpy()
    scale = np.abs(V2f).max()
    for d, view in enumerate(views):
        slab = view.v2f_slab().numpy()
        assert slab.shape == (view.M, view.Mcap)
        assert not slab[:, cp[d] < 0].any()
        own = cp[d] >= 0
        assert np.abs(slab[:, own] - V2f[:, cp[d, own]]).max(initial=0.0) <= 1e-14 * scale


def test_pair_sharded_views_hold_the_columns_of_v2f_and_w(jax_jk):
    """Three rank views on methane/3-21G: their shares add up to the JAX
    J/K, and their slabs are the columns of one build's V2f and W (equal
    bits)."""
    from qchem_rs_tpu_torch.ops.fock_pair import build_w

    system = _system("methane-321g")
    views = _views(PairSpaceShardedFockBuilder, system, 3)
    D, J_ref, K_ref = jax_jk("pair", "methane-321g")
    J, K = _summed(views, D)
    assert np.abs(J - J_ref).max() <= 1e-11
    assert np.abs(K - K_ref).max() <= 1e-11
    V2f = mirror_inplace(views[0].engine.build())
    W = build_w(V2f, views[0]._pmap.reshape(system.n_basis(), -1), views[0]._ci, views[0]._cj)
    for view in views:
        slab, Wc = view.prepare()
        assert torch.equal(slab, V2f[:, view.cols]) and torch.equal(Wc, W[:, view.cols])


@pytest.fixture(scope="module")
def water_outputs():
    """Converged RHF (pair mode) and UHF outputs of water/STO-3G on the CPU."""
    system = _system("water-sto3g")
    cfg = HartreeFockConfig(epsilon=1e-10, max_iterations=100, fock_mode="pair")
    ucfg = HartreeFockConfig(epsilon=1e-10, max_iterations=200, fock_mode="pair",
                             spin_multiplicity=1)
    return (system, cfg, restricted_hartree_fock(system, cfg, device="cpu"),
            ucfg, unrestricted_hartree_fock(system, ucfg, device="cpu"))


@pytest.mark.parametrize("kind", ["pair", "column"])
def test_whole_v2f_readers_refuse_a_sharded_builder(water_outputs, kind):
    """A sharded builder holds a column slab: ``_pair_v2f`` and its
    callers (CCSD, CIS, UCIS, UMP2 in pair space) raise instead of reading
    the slab as V2f."""
    system, cfg, out, ucfg, uout = water_outputs
    builder = BUILDERS[kind][0](system, data_mesh(device="cpu"), THRESHOLD)
    with pytest.raises(ValueError, match="column slab"):
        mp2._pair_v2f(system, cfg, torch.device("cpu"), builder)
    with pytest.raises(ValueError, match="column slab"):
        cc.ccsd(system, cfg, output=out, builder=builder, device="cpu")
    with pytest.raises(ValueError, match="column slab"):
        cis.cis(system, cfg, output=out, builder=builder, device="cpu")
    with pytest.raises(ValueError, match="column slab"):
        cis.ucis(system, ucfg, output=uout, builder=builder, device="cpu")
    with pytest.raises(ValueError, match="column slab"):
        mp2.ump2_pair_space(system, ucfg, output=uout, builder=builder, device="cpu")
