"""Port parity, polarizabilities: the port's ``static_polarizability`` and
``dynamic_polarizability`` on water/STO-3G against the JAX package's on
the same converged orbitals (the port's SCF output, given to both); the
pair-space blocks against the in-core ones; and the errors on an unstable
reference (a determinant with its HOMO and LUMO swapped)."""

import dataclasses
import os

import numpy as np
import pytest

from qchem_rs_tpu import HartreeFockConfig as JaxConfig
from qchem_rs_tpu.models import response as jax_response
from qchem_rs_tpu.utils.basis import BasisSet as JaxBasisSet
from qchem_rs_tpu.utils.system import MolecularSystem as JaxSystem
from qchem_rs_tpu_torch import (BasisSet, HartreeFockConfig, MolecularSystem,
                                dynamic_polarizability, restricted_hartree_fock,
                                static_polarizability)
from tests.torch_threads import one_torch_thread  # noqa: F401

DATA = os.path.join(os.path.dirname(__file__), "..", "data")
CFG = HartreeFockConfig(epsilon=1e-11, max_iterations=300)
OMEGAS = (0.0, 0.1, 0.3)


@pytest.fixture(scope="module")
def water():
    mpath = os.path.join(DATA, "mol", "water.json")
    bpath = os.path.join(DATA, "basis", "STO-3G.json")
    port = MolecularSystem.load(mpath, BasisSet.load(bpath))
    jsys = JaxSystem.load(mpath, JaxBasisSet.load(bpath))
    out = restricted_hartree_fock(port, CFG, device="cpu")
    jcfg = JaxConfig(epsilon=1e-11, max_iterations=300)
    ref = {"static": jax_response.static_polarizability(jsys, jcfg, output=out)}
    for w in OMEGAS:
        ref[w] = jax_response.dynamic_polarizability(jsys, jcfg, omega=w, output=out)
    return port, jsys, out, ref


def test_static_matches_jax(water):
    port, _, out, ref = water
    alpha = static_polarizability(port, CFG, output=out, device="cpu")
    assert np.abs(alpha - ref["static"]).max() <= 1e-8  # a.u.
    assert np.abs(alpha - alpha.T).max() <= 1e-10
    assert np.all(np.linalg.eigvalsh(alpha) > 0)


@pytest.mark.parametrize("omega", OMEGAS)
def test_dynamic_matches_jax(water, omega):
    port, _, out, ref = water
    alpha = dynamic_polarizability(port, CFG, omega=omega, output=out, device="cpu")
    assert np.abs(alpha - ref[omega]).max() <= 1e-8  # a.u.


def test_pair_matches_incore(water):
    port, _, out, ref = water
    pair = dataclasses.replace(CFG, fock_mode="pair")
    for fn in (static_polarizability, dynamic_polarizability):
        a = fn(port, CFG, output=out, device="cpu")
        b = fn(port, pair, output=out, device="cpu")
        assert np.abs(a - b).max() <= 1e-10  # a.u.


def test_unstable_reference_raises(water):
    """HOMO and LUMO swapped: A - B has a negative eigenvalue, and the
    static polarizability is not positive definite; both packages raise."""
    port, jsys, out, _ = water
    nocc = port.n_electrons() // 2
    swap = list(range(port.n_basis()))
    swap[nocc - 1], swap[nocc] = swap[nocc], swap[nocc - 1]
    bad = dataclasses.replace(out, coefficients=out.coefficients[:, swap],
                              orbital_energies=out.orbital_energies[swap])
    jcfg = JaxConfig(epsilon=1e-11, max_iterations=300)
    for fn, jfn in ((static_polarizability, jax_response.static_polarizability),
                    (dynamic_polarizability, jax_response.dynamic_polarizability)):
        with pytest.raises(RuntimeError, match="unstable"):
            jfn(jsys, jcfg, output=bad)
        with pytest.raises(RuntimeError, match="unstable"):
            fn(port, CFG, output=bad, device="cpu")


def test_unconverged_reference_raises():
    mpath = os.path.join(DATA, "mol", "water.json")
    port = MolecularSystem.load(mpath, BasisSet.load(os.path.join(DATA, "basis", "STO-3G.json")))
    cfg = HartreeFockConfig(epsilon=1e-14, max_iterations=2)
    out = restricted_hartree_fock(port, cfg, device="cpu")
    with pytest.raises(RuntimeError, match="not converged"):
        static_polarizability(port, cfg, output=out, device="cpu")
