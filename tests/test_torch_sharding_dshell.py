"""Port parity, the column-sharded build with d shells: water/6-31G* (6
pair classes up to (dd), d on oxygen) as three rank views of
``ColumnShardedPairFockBuilder``, which build every ordered class pair in
both tile orientations, their shares added in rank order, against the
JAX package's ``PairSpaceShardedFockBuilder`` on the 8-way virtual mesh.
The JAX package's own d-shell case, ethylene/6-31G*
(tests/test_sharding.py), has the same six classes and, on the port's
tiles at 1e-12, no screened tile; with it this file took 75 s on one
core, against a budget of ~60 s."""

import os

import jax.numpy as jnp
import numpy as np
import torch

from qchem_rs_tpu.ops.fock_pair import PairSpaceShardedFockBuilder as JaxPairSharded
from qchem_rs_tpu.parallel.mesh import data_mesh as jax_data_mesh
from qchem_rs_tpu.utils.basis import BasisSet as JaxBasisSet
from qchem_rs_tpu.utils.system import MolecularSystem as JaxSystem
from qchem_rs_tpu_torch import BasisSet, MolecularSystem
from qchem_rs_tpu_torch.ops.eri_tiled import TiledEriEngine
from qchem_rs_tpu_torch.parallel.mesh import rank_view
from qchem_rs_tpu_torch.parallel.v2_sharded import ColumnShardedPairFockBuilder, prepare_rank_views
from tests.torch_threads import one_torch_thread  # noqa: F401

DATA = os.path.join(os.path.dirname(__file__), "..", "data")


def test_column_rank_views_match_jax_with_d_shells():
    mpath = os.path.join(DATA, "mol", "water.json")
    bpath = os.path.join(DATA, "basis", "6-31G_st.json")
    jsys = JaxSystem.load(mpath, JaxBasisSet.load(bpath))
    n = jsys.n_basis()
    D = np.random.default_rng(3).standard_normal((n, n))
    D = D + D.T
    J_ref, K_ref = JaxPairSharded(jsys, jax_data_mesh(8, axis="q"), axis="q",
                                  threshold=1e-12).jk(jnp.asarray(D))
    system = MolecularSystem.load(mpath, BasisSet.load(bpath))
    engine = TiledEriEngine(system, 1e-12, device="cpu")
    assert len(engine.layout.metas) == 6
    views = [ColumnShardedPairFockBuilder(system, rank_view(3, r, "cpu"), 1e-12, engine=engine)
             for r in range(3)]
    prepare_rank_views(views)
    J = K = 0.0
    for view in views:
        Jr, Kr = view.jk_partial(torch.tensor(D))
        J, K = J + Jr.numpy(), K + Kr.numpy()
    assert np.abs(J - np.asarray(J_ref)).max() <= 1e-11
    assert np.abs(K - np.asarray(K_ref)).max() <= 1e-11
