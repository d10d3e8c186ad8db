"""Port parity, properties: the port's dipole integrals, dipole moment and
Mulliken charges against the JAX package's on the same inputs (Cartesian
water/6-31G* and spherical OH/6-31G*), and the Mulliken charges of a
converged port density summing to the molecular charge."""

import os

import numpy as np
import pytest

from qchem_rs_tpu.models import properties as jax_properties
from qchem_rs_tpu.ops import one_electron as jax_one_electron
from qchem_rs_tpu.utils.basis import BasisSet as JaxBasisSet
from qchem_rs_tpu.utils.system import MolecularSystem as JaxSystem
from qchem_rs_tpu_torch import (BasisSet, HartreeFockConfig, MolecularSystem,
                                restricted_hartree_fock, unrestricted_hartree_fock)
from qchem_rs_tpu_torch.models import properties
from qchem_rs_tpu_torch.ops import one_electron
from tests.torch_threads import one_torch_thread  # noqa: F401

DATA = os.path.join(os.path.dirname(__file__), "..", "data")
CASES = {"water 6-31G*": ("water", False), "OH 6-31G* spherical": ("hydroxyl", True)}


def _paths(mol):
    return os.path.join(DATA, "mol", f"{mol}.json"), os.path.join(DATA, "basis", "6-31G_st.json")


@pytest.fixture(scope="module", params=sorted(CASES))
def systems(request):
    """(port system, JAX system, a random symmetric density) of one case."""
    mol, spherical = CASES[request.param]
    mpath, bpath = _paths(mol)
    port = MolecularSystem.load(mpath, BasisSet.load(bpath), spherical=spherical)
    jsys = JaxSystem.load(mpath, JaxBasisSet.load(bpath), spherical=spherical)
    n = port.n_basis()
    D = np.random.default_rng(n).normal(size=(n, n))
    return port, jsys, D + D.T


def test_dipole_integrals_match_jax(systems):
    port, jsys, _ = systems
    out = one_electron.dipole_integrals(port, "cpu").numpy()
    ref = np.asarray(jax_one_electron.dipole_integrals(jsys))
    assert out.shape == ref.shape == (3, port.n_basis(), port.n_basis())
    assert np.max(np.abs(out - ref)) <= 1e-12


def test_dipole_moment_matches_jax(systems):
    port, jsys, D = systems
    np.testing.assert_allclose(properties.dipole_moment(port, D, "cpu"),
                               jax_properties.dipole_moment(jsys, D), rtol=0, atol=1e-10)


def test_mulliken_charges_match_jax(systems):
    port, jsys, D = systems
    np.testing.assert_allclose(properties.mulliken_charges(port, D, "cpu"),
                               jax_properties.mulliken_charges(jsys, D), rtol=0, atol=1e-10)


def test_spin_expectation_is_reexported():
    from qchem_rs_tpu_torch.models.uhf import spin_expectation

    assert properties.spin_expectation is spin_expectation
    assert properties.AU_TO_DEBYE == jax_properties.AU_TO_DEBYE


@pytest.mark.parametrize("mol,charge,mult", [("hydroxyl", -1, 1), ("water", 1, 2), ("water", 0, 1)])
def test_mulliken_charges_sum_to_the_molecular_charge(mol, charge, mult):
    # sum_A q_A = sum_A Z_A - Tr[D S] = sum_A Z_A - N = the molecular charge
    system = MolecularSystem.load(os.path.join(DATA, "mol", f"{mol}.json"),
                                  BasisSet.load(os.path.join(DATA, "basis", "STO-3G.json")))
    cfg = HartreeFockConfig(epsilon=1e-8, charge=charge, spin_multiplicity=mult)
    if mult == 1:
        D = restricted_hartree_fock(system, cfg, device="cpu").density
    else:
        D = unrestricted_hartree_fock(system, cfg, device="cpu").density.sum(0)
    q = properties.mulliken_charges(system, D, "cpu")
    assert q.shape == (len(system.atoms),)
    assert abs(q.sum() - charge) <= 1e-10


def test_properties_default_to_cuda_and_raise_without_it():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the test covers the machine without it")
    mpath, bpath = _paths("water")
    system = MolecularSystem.load(mpath, BasisSet.load(bpath))
    D = np.eye(system.n_basis())
    for fn in (properties.dipole_moment, properties.mulliken_charges):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fn(system, D)
