"""Port parity, the pair-space Fock build: ``qchem_rs_tpu_torch.ops.fock_pair``
on the CPU (kernel 2 through its plain twin) against the JAX package's
``PairSpaceFockBuilder`` and against dense formulas from ``finish_eri``."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qchem_rs_tpu.ops.fock_pair import PairSpaceFockBuilder as JaxPairBuilder
from qchem_rs_tpu.ops.fock_pair import pair_row_ao as jax_pair_row_ao
from qchem_rs_tpu.utils.basis import BasisSet as JaxBasisSet
from qchem_rs_tpu.utils.system import MolecularSystem as JaxSystem
from qchem_rs_tpu_torch import BasisSet, MolecularSystem
from qchem_rs_tpu_torch.ops import fock_pair
from qchem_rs_tpu_torch.ops.eri_tiled import TiledEriEngine
from qchem_rs_tpu_torch.ops.fock_pair import PairSpaceFockBuilder, build_w, exchange_lean
from tests.torch_threads import one_torch_thread  # noqa: F401

DATA = os.path.join(os.path.dirname(__file__), "..", "data")
CASES = [("STO-3G", "water"), ("6-31G", "methane")]


def _paths(basis, mol):
    return os.path.join(DATA, "mol", f"{mol}.json"), os.path.join(DATA, "basis", f"{basis}.json")


def _system(basis, mol):
    mpath, bpath = _paths(basis, mol)
    return MolecularSystem.load(mpath, BasisSet.load(bpath))


def _density(n, seed):
    D = np.random.default_rng(seed).standard_normal((n, n))
    return D + D.T  # densities are symmetric


@pytest.fixture(scope="module", params=CASES, ids=["water-sto3g", "methane-631g"])
def case(request):
    """The JAX builder's J and K (threshold 1e-14, as the JAX package's own
    test) for a random symmetric density, and the port's system."""
    basis, mol = request.param
    mpath, bpath = _paths(basis, mol)
    jsys = JaxSystem.load(mpath, JaxBasisSet.load(bpath))
    D = _density(jsys.n_basis(), 3)
    J, K = JaxPairBuilder(jsys, threshold=1e-14, lean=False).jk(jnp.asarray(D))
    return _system(basis, mol), D, np.asarray(J), np.asarray(K), jsys


@pytest.mark.parametrize("lean", [False, True], ids=["w", "lean"])
def test_pair_jk_matches_jax(case, lean):
    system, D, J_ref, K_ref, _ = case
    builder = PairSpaceFockBuilder(system, 1e-14, device="cpu", lean=lean)
    J, K = builder.jk(torch.tensor(D))
    assert builder.lean is lean and (builder.prepare()[1] is None) is lean
    scale = max(np.abs(J_ref).max(), 1.0)  # tests/test_fock_pair.py:36-38
    assert np.abs(J.numpy() - J_ref).max() / scale < 1e-11
    assert np.abs(K.numpy() - K_ref).max() / scale < 1e-11


def test_pair_row_ao_matches_jax(case):
    from qchem_rs_tpu.ops.eri_tiled import TiledEriEngine as JaxEngine

    system, jsys = case[0], case[4]
    out = fock_pair.pair_row_ao(TiledEriEngine(system, 0.0, device="cpu").layout)
    ref = jax_pair_row_ao(JaxEngine(jsys, 0.0).layout)
    # the two layouts pad classes to other lengths: compare the real rows,
    # in V2 order (their AO pairs and redundant-row marks)
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a[out[0] >= 0], b[ref[0] >= 0])


@pytest.fixture(scope="module")
def water_e4():
    """Water/STO-3G: the engine, its mirrored V2 and the dense (ij|kl)."""
    system = _system("STO-3G", "water")
    engine = TiledEriEngine(system, 0.0, device="cpu")
    V2f = engine.build()
    e4 = engine.finish_eri(V2f).numpy()  # mirrors V2f in place
    return engine, V2f, e4


def test_build_w_matches_dense_formula(water_e4):
    engine, V2f, e4 = water_e4
    n = e4.shape[0]
    row_i, row_j, _ = fock_pair.pair_row_ao(engine.layout)
    ci, cj = np.where(row_i < 0, 0, row_i), np.where(row_j < 0, 0, row_j)
    pmap2 = torch.as_tensor(engine.layout.pmap).reshape(n, n)
    W = build_w(V2f, pmap2, torch.as_tensor(ci), torch.as_tensor(cj)).numpy()
    # W[(i, k), m] = (i ci_m | k cj_m) + (i cj_m | k ci_m)
    ref = e4[:, ci, :, cj].transpose(1, 2, 0) + e4[:, cj, :, ci].transpose(1, 2, 0)
    assert W.shape == (n * n, engine.layout.M)
    np.testing.assert_allclose(W, ref.reshape(n * n, -1), rtol=0, atol=1e-14)


def test_exchange_lean_matches_dense_formula(water_e4):
    engine, V2f, e4 = water_e4
    n = e4.shape[0]
    D = _density(n, 11)
    pmap2 = torch.as_tensor(engine.layout.pmap).reshape(n, n)
    K = exchange_lean(V2f, pmap2, torch.tensor(D)).numpy()
    np.testing.assert_allclose(K, np.einsum("ijkl,jl->ik", e4, D), rtol=0, atol=1e-13)


@pytest.mark.parametrize("budget,lean", [("1e15", False), ("0", True)])
def test_lean_follows_the_budget(monkeypatch, budget, lean):
    system = _system("STO-3G", "hydrogen")
    monkeypatch.setenv(fock_pair.BUDGET_ENV, budget)
    assert PairSpaceFockBuilder(system, device="cpu").lean is lean


def test_default_budget_is_half_the_host_memory(monkeypatch):
    monkeypatch.delenv(fock_pair.BUDGET_ENV, raising=False)
    host = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    assert fock_pair.pair_budget(torch.device("cpu")) == 0.5 * host
