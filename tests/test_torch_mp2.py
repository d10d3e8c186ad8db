"""Port parity, MP2: the port's ``mp2``/``mp2_pair_space`` and
``ump2``/``ump2_pair_space`` against the JAX package's ``mp2``/``ump2`` on the
same converged orbitals (the port's SCF output, passed to both as
``output=``), with no core frozen and with the chemical core; spherical
UMP2 lifts C to the Cartesian V2f; UMP2 on a closed shell is RMP2."""

import os

import numpy as np
import pytest
import torch

from qchem_rs_tpu import HartreeFockConfig as JaxConfig
from qchem_rs_tpu.models import mp2 as jax_mp2
from qchem_rs_tpu.utils.basis import BasisSet as JaxBasisSet
from qchem_rs_tpu.utils.system import MolecularSystem as JaxSystem
from qchem_rs_tpu_torch import (BasisSet, HartreeFockConfig, MolecularSystem,
                                restricted_hartree_fock, unrestricted_hartree_fock)
from qchem_rs_tpu_torch.models import mp2
from qchem_rs_tpu_torch.ops.fock_pair import PairSpaceFockBuilder
from tests.torch_threads import one_torch_thread  # noqa: F401

DATA = os.path.join(os.path.dirname(__file__), "..", "data")


def _paths(mol, basis):
    return os.path.join(DATA, "mol", f"{mol}.json"), os.path.join(DATA, "basis", f"{basis}.json")


def _systems(mol, basis, spherical=False):
    mpath, bpath = _paths(mol, basis)
    return (MolecularSystem.load(mpath, BasisSet.load(bpath), spherical=spherical),
            JaxSystem.load(mpath, JaxBasisSet.load(bpath), spherical=spherical))


@pytest.fixture(scope="module", params=["STO-3G", "6-31G"])
def water(request):
    """Water's port RHF at diag_rms 1e-10, and the JAX package's MP2 on its
    orbitals with frozen 0 and "auto"."""
    port, jsys = _systems("water", request.param)
    out = restricted_hartree_fock(port, HartreeFockConfig(epsilon=1e-10), device="cpu")
    ref = {fz: jax_mp2.mp2(jsys, JaxConfig(epsilon=1e-10), frozen=fz, output=out).correlation_energy
           for fz in (0, "auto")}
    return port, out, ref


@pytest.mark.parametrize("frozen", [0, "auto"])
@pytest.mark.parametrize("fn", ["mp2", "mp2_pair_space"])
def test_rmp2_matches_jax(water, fn, frozen):
    port, out, ref = water
    res = getattr(mp2, fn)(port, HartreeFockConfig(epsilon=1e-10), frozen=frozen, output=out,
                           device="cpu")
    assert res.correlation_energy < 0.0
    assert abs(res.correlation_energy - ref[frozen]) <= 1e-10
    assert res.scf_total_energy == out.total_energy() and res.iterations == out.iterations
    assert set(res.timings) == {"eri_s", "transform_s", "total_s"}


def test_mp2_pair_space_reuses_a_prepared_builder(water):
    port, out, ref = water
    builder = PairSpaceFockBuilder(port, 1e-12, device="cpu")
    V2f, _ = builder.prepare()
    marker = V2f.clone()
    res = mp2.mp2_pair_space(port, frozen=0, output=out, builder=builder, device="cpu")
    assert abs(res.correlation_energy - ref[0]) <= 1e-10
    assert builder._prepared[0] is V2f and torch.equal(V2f, marker)


# (molecule, multiplicity, spherical)
UMP2_CASES = {"O2 triplet": ("oxygen", 3, False), "O2 triplet spherical": ("oxygen", 3, True),
              "OH doublet": ("hydroxyl", 2, False), "OH doublet spherical": ("hydroxyl", 2, True)}


@pytest.fixture(scope="module", params=sorted(UMP2_CASES))
def open_shell(request):
    """An open shell's port UHF in STO-3G at diag_rms 1e-10, and the JAX
    package's UMP2 on its orbitals. O2 from Hückel takes some 360 passes
    (as in tests/test_mp2.py, which allows 400)."""
    mol, mult, spherical = UMP2_CASES[request.param]
    port, jsys = _systems(mol, "STO-3G", spherical)
    cfg = dict(epsilon=1e-10, max_iterations=400, spin_multiplicity=mult)
    out = unrestricted_hartree_fock(port, HartreeFockConfig(**cfg), device="cpu")
    ref = jax_mp2.ump2(jsys, JaxConfig(**cfg), output=out).correlation_energy
    return port, cfg, out, ref


@pytest.mark.parametrize("fn", ["ump2", "ump2_pair_space"])
def test_ump2_matches_jax(open_shell, fn):
    port, cfg, out, ref = open_shell
    assert out.converged
    res = getattr(mp2, fn)(port, HartreeFockConfig(**cfg), output=out, device="cpu")
    assert res.correlation_energy < 0.0
    assert abs(res.correlation_energy - ref) <= 1e-10


@pytest.mark.parametrize("frozen", [0, "auto"])
def test_ump2_on_a_closed_shell_is_rmp2(frozen):
    port, _ = _systems("water", "6-31G")
    cfg = HartreeFockConfig(epsilon=1e-10, max_iterations=300)
    rmp2 = mp2.mp2(port, cfg, frozen=frozen, device="cpu")
    ump2 = mp2.ump2(port, cfg, frozen=frozen, device="cpu")
    ump2_pair = mp2.ump2_pair_space(port, cfg, frozen=frozen, device="cpu")
    assert abs(ump2.correlation_energy - rmp2.correlation_energy) <= 1e-10
    assert abs(ump2_pair.correlation_energy - rmp2.correlation_energy) <= 1e-10


def test_frozen_core_counts_and_errors():
    port, _ = _systems("water", "STO-3G")
    assert mp2._n_frozen(port, "auto") == 1 and mp2._n_frozen(port, 3) == 3
    with pytest.raises(ValueError, match=">= 0"):
        mp2._n_frozen(port, -1)
    out = restricted_hartree_fock(port, HartreeFockConfig(epsilon=1e-8), device="cpu")
    with pytest.raises(ValueError, match="no correlated"):
        mp2.mp2(port, frozen=5, output=out, device="cpu")
    with pytest.raises(RuntimeError, match="not converged"):
        mp2.mp2(port, HartreeFockConfig(max_iterations=1), device="cpu")
    zn = MolecularSystem.from_arrays(np.array([30]), np.zeros((1, 3)),
                                     BasisSet.load(_paths("water", "6-31G_st")[1]))
    with pytest.raises(ValueError, match="Z=30"):
        mp2._n_frozen(zn, "auto")
