"""Port parity, harmonic frequencies: the port's ``harmonic_frequencies``
on H2/STO-3G at its input geometry (1.4 Bohr, steps of 5e-3 Bohr) against
the JAX package's, the Hessian within 1e-6 and the stretch within 0.5
cm^-1; and the error for an atom with no tabulated mass, raised before any
SCF. One JAX Hessian in all."""

import os

import numpy as np
import pytest

from qchem_rs_tpu import HartreeFockConfig as JaxConfig
from qchem_rs_tpu.models import hessian as jax_hessian
from qchem_rs_tpu.utils.basis import BasisSet as JaxBasisSet
from qchem_rs_tpu.utils.system import MolecularSystem as JaxSystem
from qchem_rs_tpu_torch import Atom, BasisSet, HartreeFockConfig, MolecularSystem
from qchem_rs_tpu_torch.models import hessian
from qchem_rs_tpu_torch.utils.basis import ShellSpec
from tests.torch_threads import one_torch_thread  # noqa: F401

DATA = os.path.join(os.path.dirname(__file__), "..", "data")


@pytest.fixture(scope="module")
def hydrogen():
    mpath = os.path.join(DATA, "mol", "hydrogen.json")
    bpath = os.path.join(DATA, "basis", "STO-3G.json")
    port = MolecularSystem.load(mpath, BasisSet.load(bpath))
    ours = hessian.harmonic_frequencies(
        port, HartreeFockConfig(epsilon=1e-11, max_iterations=300), device="cpu")
    ref = jax_hessian.harmonic_frequencies(JaxSystem.load(mpath, JaxBasisSet.load(bpath)),
                                           JaxConfig(epsilon=1e-11, max_iterations=300))
    return ours, ref


def test_hessian_matches_jax(hydrogen):
    ours, ref = hydrogen
    assert ours.hessian.shape == (6, 6)
    assert np.abs(ours.hessian - ref.hessian).max() <= 1e-6  # Eh/Bohr^2
    assert np.abs(ours.hessian - ours.hessian.T).max() == 0.0


def test_stretch_frequency_matches_jax(hydrogen):
    ours, ref = hydrogen
    assert abs(ours.frequencies_cm1[-1] - ref.frequencies_cm1[-1]) <= 0.5  # cm^-1
    assert 5000.0 < ours.frequencies_cm1[-1] < 6000.0
    assert ours.n_zero_modes == ref.n_zero_modes


def test_missing_mass_raises_before_any_scf():
    shell = ShellSpec(l=0, exponents=np.array([1.0]), coefficients=np.array([1.0]))
    potassium = MolecularSystem([Atom(19, np.zeros(3))], BasisSet("dummy", {19: [shell]}))
    with pytest.raises(ValueError, match="no atomic mass"):
        # a device that does not exist: the check must come first
        hessian.harmonic_frequencies(potassium, device="no-such-device")
