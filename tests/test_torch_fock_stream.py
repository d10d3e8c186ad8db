"""Port parity, the streaming integral-direct Fock build:
``qchem_rs_tpu_torch.ops.fock_stream`` on the CPU (kernel 3 through its plain
twin) against the JAX package's ``StreamingFockBuilder`` and against the
port's own pair-space builder, in the CPU's batches and in kernel 3's batch
rule cut small."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qchem_rs_tpu.ops.fock_stream import StreamingFockBuilder as JaxStreamingBuilder
from qchem_rs_tpu.utils.basis import BasisSet as JaxBasisSet
from qchem_rs_tpu.utils.system import MolecularSystem as JaxSystem
from qchem_rs_tpu_torch import BasisSet, MolecularSystem
from qchem_rs_tpu_torch.ops import eri_tiled
from qchem_rs_tpu_torch.ops.fock_pair import PairSpaceFockBuilder
from qchem_rs_tpu_torch.ops.fock_stream import StreamingFockBuilder
from tests.torch_threads import one_torch_thread  # noqa: F401

DATA = os.path.join(os.path.dirname(__file__), "..", "data")


def _paths(basis, mol):
    return os.path.join(DATA, "mol", f"{mol}.json"), os.path.join(DATA, "basis", f"{basis}.json")


def _densities(nd, n, seed):
    D = np.random.default_rng(seed).standard_normal((nd, n, n))
    return D + D.transpose(0, 2, 1)


def _rel(out, ref):
    ref = np.asarray(ref)
    return np.abs(np.asarray(out) - ref).max() / max(np.abs(ref).max(), 1.0)


@pytest.fixture(scope="module")
def water():
    """Water/STO-3G: the JAX builder's J and K of a two-density stack, and
    the port's builder."""
    mpath, bpath = _paths("STO-3G", "water")
    jsys = JaxSystem.load(mpath, JaxBasisSet.load(bpath))
    D = _densities(2, jsys.n_basis(), 5)
    J, K = JaxStreamingBuilder(jsys, threshold=1e-12).jk_stack_cart(jnp.asarray(D))
    builder = StreamingFockBuilder(MolecularSystem.load(mpath, BasisSet.load(bpath)), 1e-12,
                                   device="cpu")
    return builder, D, np.asarray(J), np.asarray(K)


@pytest.mark.parametrize("nd", [1, 2])
def test_jk_stack_matches_jax(water, nd):
    builder, D, J_ref, K_ref = water
    J, K = builder.jk_stack_cart(torch.tensor(D[:nd]))
    assert J.shape == K.shape == (nd,) + D.shape[1:]
    assert _rel(J, J_ref[:nd]) < 1e-11
    assert _rel(K, K_ref[:nd]) < 1e-11


def test_jk_is_the_first_of_a_stack(water):
    builder, D, J_ref, K_ref = water
    J, K = builder.jk(torch.tensor(D[1]))
    assert _rel(J, J_ref[1]) < 1e-11 and _rel(K, K_ref[1]) < 1e-11


@pytest.fixture(scope="module")
def methane():
    """Methane/6-31G: the direct and pair builders over one engine."""
    mpath, bpath = _paths("6-31G", "methane")
    direct = StreamingFockBuilder(MolecularSystem.load(mpath, BasisSet.load(bpath)), 1e-12,
                                  device="cpu")
    pair = PairSpaceFockBuilder(direct.system, 1e-12, device="cpu", engine=direct.engine)
    pair.prepare()
    return direct, pair


@pytest.mark.parametrize("nd", [1, 2])
def test_jk_stack_matches_pair_builder(methane, nd):
    direct, pair = methane
    D = torch.tensor(_densities(nd, direct.nao, 9))
    J, K = direct.jk_stack_cart(D)
    for s in range(nd):
        J_ref, K_ref = pair.jk(D[s])
        assert _rel(J[s], J_ref) < 1e-11
        assert _rel(K[s], K_ref) < 1e-11


def test_diagonal_tiles_are_square_and_on_the_diagonal(methane):
    # the halving of self-transposed tiles needs same-class tiles that are
    # square, on or above the diagonal, and diagonal exactly when ti == tj
    direct, _ = methane
    metas = direct.engine.layout.metas
    same = [(i1, ti, tj) for i1, i2, ti, tj in direct.batches if i1 == i2]
    assert same
    for i1, ti, tj in same:
        T = metas[i1].tile  # aligned tiles are equal or disjoint: ti == tj is the diagonal
        assert (tj >= ti).all() and (ti % T == 0).all() and (tj % T == 0).all()
    covered = {(i1, i2) for i1, i2, _, _ in direct.batches}
    assert covered == {(i1, i2) for i1, i2, _, _ in direct.engine._tasks}


def test_batches_cover_every_tile_once(methane):
    direct, _ = methane
    got = sorted((i1, i2, a, b) for i1, i2, ti, tj in direct.batches for a, b in zip(ti, tj))
    want = sorted((i1, i2, a, b) for i1, i2, ti, tj in direct.engine._tasks for a, b in zip(ti, tj))
    assert got == want


def _kernel3_batches(builder, monkeypatch):
    """Cut the builder's pass in kernel 3's batch rule (as on the card),
    with a batch budget small enough that class pairs of several tiles take
    several batches; the shared builder gets its own batches back after
    the test."""
    monkeypatch.setattr(eri_tiled, "BATCH_BYTES", 1 << 13)
    monkeypatch.setattr(builder, "batches", builder.batches)
    monkeypatch.setattr(builder, "_offsets", builder._offsets)
    eng = builder.engine
    builder._plan(list(eng.batches(twin=False, values=True)))


@pytest.mark.parametrize("nd", [1, 2])
def test_jk_stack_in_kernel3_batches_matches_jax(water, nd, monkeypatch):
    builder, D, J_ref, K_ref = water
    _kernel3_batches(builder, monkeypatch)
    J, K = builder.jk_stack_cart(torch.tensor(D[:nd]))
    assert _rel(J, J_ref[:nd]) < 1e-11
    assert _rel(K, K_ref[:nd]) < 1e-11


@pytest.mark.parametrize("nd", [1, 2])
def test_jk_stack_in_kernel3_batches_matches_pair_builder(methane, nd, monkeypatch):
    direct, pair = methane
    _kernel3_batches(direct, monkeypatch)
    assert len(direct.batches) > len(direct.engine._tasks)
    D = torch.tensor(_densities(nd, direct.nao, 11))
    J, K = direct.jk_stack_cart(D)
    for s in range(nd):
        J_ref, K_ref = pair.jk(D[s])
        assert _rel(J[s], J_ref) < 1e-11
        assert _rel(K[s], K_ref) < 1e-11
