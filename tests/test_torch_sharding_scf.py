"""Port parity, SCF and MP2 through the sharded Fock builders on the CPU:
the port's ``_rhf_scf`` with G from each sharded builder (three rank views
added in rank order for the streaming and column builders, the one-device
mesh for the pair builder, whose M = 37 on water/STO-3G divides by no
larger size) against the JAX package's ``_rhf_scf_direct`` with its
``PairSpaceShardedFockBuilder`` on the 8-way virtual mesh; ``mp2_pair_space``
through the port's sharded pair builders against the JAX function with
its sharded builder, on the same orbitals; and a UHF run whose J/K stack
comes from three rank views of ``ShardedFockBuilder`` against the port's
unsharded direct UHF."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qchem_rs_tpu import HartreeFockConfig as JaxConfig
from qchem_rs_tpu.models import scf as jax_scf
from qchem_rs_tpu.models.mp2 import mp2_pair_space as jax_mp2_pair_space
from qchem_rs_tpu.models.rhf import _rhf_scf_direct
from qchem_rs_tpu.ops import one_electron as jax_one_electron
from qchem_rs_tpu.ops.fock_pair import PairSpaceShardedFockBuilder as JaxPairSharded
from qchem_rs_tpu.parallel.mesh import data_mesh as jax_data_mesh
from qchem_rs_tpu.utils.basis import BasisSet as JaxBasisSet
from qchem_rs_tpu.utils.system import MolecularSystem as JaxSystem
from qchem_rs_tpu_torch import BasisSet, HartreeFockConfig, MolecularSystem, mp2_pair_space
from qchem_rs_tpu_torch import restricted_hartree_fock, unrestricted_hartree_fock
from qchem_rs_tpu_torch.models import scf
from qchem_rs_tpu_torch.models.rhf import _rhf_scf, core_hamiltonian
from qchem_rs_tpu_torch.models.uhf import _uhf_scf
from qchem_rs_tpu_torch.ops.eri_tiled import TiledEriEngine
from qchem_rs_tpu_torch.ops.fock_pair import PairSpaceShardedFockBuilder
from qchem_rs_tpu_torch.parallel.fock_sharded import ShardedFockBuilder
from qchem_rs_tpu_torch.parallel.mesh import data_mesh, rank_view
from qchem_rs_tpu_torch.parallel.v2_sharded import ColumnShardedPairFockBuilder, prepare_rank_views
from tests.torch_threads import one_torch_thread  # noqa: F401

DATA = os.path.join(os.path.dirname(__file__), "..", "data")
THRESHOLD = 1e-12
CFG = dict(epsilon=1e-12, max_iterations=200)  # a fixed point, not a stop rule


def _paths(mol, basis):
    return os.path.join(DATA, "mol", f"{mol}.json"), os.path.join(DATA, "basis", f"{basis}.json")


@pytest.fixture(scope="module")
def water():
    mpath, bpath = _paths("water", "STO-3G")
    return MolecularSystem.load(mpath, BasisSet.load(bpath))


@pytest.fixture(scope="module")
def jax_water():
    """The JAX package's RHF energy through ``_rhf_scf_direct`` with its
    sharded pair builder on the 8-way mesh, and the builder (kept for
    MP2)."""
    mpath, bpath = _paths("water", "STO-3G")
    jsys = JaxSystem.load(mpath, JaxBasisSet.load(bpath))
    cfg = JaxConfig(**CFG)
    builder = JaxPairSharded(jsys, jax_data_mesh(8, axis="q"), axis="q", threshold=THRESHOLD)
    V2f, W = builder.prepare()
    pos = jnp.asarray(jsys.positions)
    S = jax_one_electron.overlap(jsys, pos)
    H = jax_one_electron.kinetic(jsys, pos) + jax_one_electron.nuclear(jsys, pos)
    X = jax_scf.lowdin_x(S)
    nocc = jsys.n_electrons(0) // 2

    def run(H, X, S, V2f, W):
        return _rhf_scf_direct(H, X, S, nocc, cfg, lambda D: builder.jk_sph(D, V2f, W))

    st = jax.jit(run)(H, X, S, V2f, W)
    assert bool(st.converged)
    return float(st.energy) + jsys.nuclear_repulsion(), jsys, builder


def _g_fn(kind, system):
    """G = J - K/2 of a density: from three rank views added in rank order
    (streaming, column), or the pair builder on the one-device mesh."""
    engine = TiledEriEngine(system, THRESHOLD, device="cpu")
    if kind == "pair":
        builder = PairSpaceShardedFockBuilder(system, data_mesh(device="cpu"), THRESHOLD,
                                              engine=engine)
        views, jk = [builder], lambda b, D: b.jk(D)
    else:
        cls = ShardedFockBuilder if kind == "stream" else ColumnShardedPairFockBuilder
        views = [cls(system, rank_view(3, r, "cpu"), THRESHOLD, engine=engine) for r in range(3)]
        if kind == "column":
            prepare_rank_views(views)
        jk = lambda b, D: b.jk_partial(D)  # noqa: E731

    def g_fn(D):
        J = K = 0.0
        for view in views:
            Jr, Kr = jk(view, D)
            J, K = J + Jr, K + Kr
        return J - 0.5 * K

    return g_fn


@pytest.mark.parametrize("kind", ["stream", "pair", "column"])
def test_rhf_through_a_sharded_builder_matches_jax(water, jax_water, kind):
    cfg = HartreeFockConfig(**CFG)
    S, H, X, _ = core_hamiltonian(water, torch.device("cpu"))
    st = _rhf_scf(H, X, S, water.n_electrons(0) // 2, cfg, _g_fn(kind, water))
    assert st.converged
    assert abs(st.energy + water.nuclear_repulsion() - jax_water[0]) <= 1e-10


@pytest.mark.parametrize("kind", ["pair", "column"])
def test_sharded_mp2_matches_jax(water, jax_water, kind):
    """MP2 through a sharded builder on the one-device mesh, against the
    JAX package's with its sharded builder, both on the port's orbitals."""
    cfg = HartreeFockConfig(**CFG)
    out = restricted_hartree_fock(water, cfg, device="cpu")
    _, jsys, jbuilder = jax_water
    ref = jax_mp2_pair_space(jsys, JaxConfig(**CFG), output=out, builder=jbuilder)
    cls = PairSpaceShardedFockBuilder if kind == "pair" else ColumnShardedPairFockBuilder
    res = mp2_pair_space(water, cfg, output=out, device="cpu",
                         builder=cls(water, data_mesh(device="cpu"), THRESHOLD))
    assert abs(res.correlation_energy - ref.correlation_energy) <= 1e-10
    assert res.correlation_energy < -0.03


def test_uhf_through_sharded_stream_views():
    """UHF on OH/STO-3G with each pass's J/K stack (both spins in one
    recomputation) from three rank views of ShardedFockBuilder, against
    the port's unsharded direct UHF."""
    mpath, bpath = _paths("hydroxyl", "STO-3G")
    system = MolecularSystem.load(mpath, BasisSet.load(bpath))
    cfg = HartreeFockConfig(epsilon=1e-12, max_iterations=300, spin_multiplicity=2,
                            fock_mode="direct")
    ref = unrestricted_hartree_fock(system, cfg, device="cpu")
    engine = TiledEriEngine(system, cfg.screening_threshold, device="cpu")
    views = [ShardedFockBuilder(system, rank_view(3, r, "cpu"), cfg.screening_threshold,
                                engine=engine) for r in range(3)]

    def jk_fn(D):
        Js = Ks = 0.0
        for view in views:
            Jr, Kr = view.jk_partial(D)
            Js, Ks = Js + Jr, Ks + Kr
        return Js[0] + Js[1], Ks

    S, H, X, _ = core_hamiltonian(system, torch.device("cpu"))
    nocc = scf.electron_counts(system.n_electrons(0), 2)
    st = _uhf_scf(H, X, S, nocc, cfg, jk_fn)
    assert st.converged and ref.converged
    assert abs(st.energy - ref.electronic_energy) <= 1e-10
    assert np.abs(st.density.numpy() - ref.density).max() <= 1e-8
