"""Port parity, thermochemistry: the port's ``thermochemistry`` against the
JAX package's on the same frequency arrays (H2, water with its
translation and rotation modes, the argon atom), every field within 1e-12
relative, and its rejection of a non-positive temperature."""

import numpy as np
import pytest

from qchem_rs_tpu.models import thermo as jax_thermo
from qchem_rs_tpu.utils.basis import BasisSet as JaxBasisSet
from qchem_rs_tpu.utils.basis import ShellSpec as JaxShellSpec
from qchem_rs_tpu.utils.system import Atom as JaxAtom
from qchem_rs_tpu.utils.system import MolecularSystem as JaxSystem
from qchem_rs_tpu_torch import Atom, BasisSet, MolecularSystem
from qchem_rs_tpu_torch.models import thermo
from qchem_rs_tpu_torch.utils.basis import ShellSpec
from tests.torch_threads import one_torch_thread  # noqa: F401

RTOL = 1e-12


def _argon(Sys, Basis, Spec, AtomCls):
    shell = Spec(l=0, exponents=np.array([1.0]), coefficients=np.array([1.0]))
    return Sys([AtomCls(18, np.zeros(3))], Basis("dummy", {18: [shell]}))


def _pair(mol):
    import os

    data = os.path.join(os.path.dirname(__file__), "..", "data")
    mpath = os.path.join(data, "mol", f"{mol}.json")
    bpath = os.path.join(data, "basis", "STO-3G.json")
    return (MolecularSystem.load(mpath, BasisSet.load(bpath)),
            JaxSystem.load(mpath, JaxBasisSet.load(bpath)))


# (system, frequencies, keyword arguments)
CASES = {
    "H2 sigma 2": ("hydrogen", [-3.0, 1.0, 2.0, 4.0, 7.0, 4401.2], dict(symmetry_number=2)),
    "water with trans/rot modes": ("water", [-12.0, 0.5, 3.0, 8.0, 20.0, 31.0, 1700.0, 3800.0,
                                             3900.0], dict(symmetry_number=2)),
    "water hot, imaginary mode": ("water", [-250.0, 1700.0, 3800.0, 3900.0],
                                  dict(temperature=1500.0, pressure=2.0e5)),
    "water doublet cold": ("water", [1700.0, 3800.0, 3900.0],
                           dict(temperature=10.0, spin_multiplicity=2)),
    "argon 1 bar": ("argon", [], dict(pressure=1.0e5)),
}


def _close(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return a.shape == b.shape and bool(np.all(np.abs(a - b) <= RTOL * np.abs(b)))


@pytest.mark.parametrize("case", sorted(CASES))
def test_thermochemistry_matches_jax(case):
    mol, freqs, kw = CASES[case]
    if mol == "argon":
        port = _argon(MolecularSystem, BasisSet, ShellSpec, Atom)
        jsys = _argon(JaxSystem, JaxBasisSet, JaxShellSpec, JaxAtom)
    else:
        port, jsys = _pair(mol)
    ours = thermo.thermochemistry(port, freqs, **kw)
    ref = jax_thermo.thermochemistry(jsys, freqs, **kw)
    for field in ("temperature", "pressure", "zpe", "thermal_energy", "thermal_enthalpy",
                  "thermal_gibbs", "entropy", "rotational_temperatures"):
        assert _close(getattr(ours, field), getattr(ref, field)), field
    for part, value in ref.entropy_parts.items():
        assert _close(ours.entropy_parts[part], value), part
    assert (ours.linear, ours.n_vibrations) == (ref.linear, ref.n_vibrations)


def test_principal_moments_match_jax():
    port, jsys = _pair("water")
    assert _close(thermo._principal_moments(port), jax_thermo._principal_moments(jsys))


def test_non_positive_temperature_raises():
    port, _ = _pair("hydrogen")
    with pytest.raises(ValueError):
        thermo.thermochemistry(port, [4401.2], temperature=0.0)
