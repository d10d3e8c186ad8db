"""Port parity, geometry optimization: the port's ``optimize_geometry`` on
H2/STO-3G (from 1.4 Bohr) against the JAX package's and the textbook RHF
bond of 1.346 Bohr; and the open-shell OH/STO-3G optimization held to its
own checks (bond length, final gradient, the final gradient against a
central difference of the energy), since the JAX package's own OH
optimization does not converge. One JAX optimization in all."""

import os

import numpy as np
import pytest

from qchem_rs_tpu import HartreeFockConfig as JaxConfig
from qchem_rs_tpu.models import optimize as jax_optimize
from qchem_rs_tpu.utils.basis import BasisSet as JaxBasisSet
from qchem_rs_tpu.utils.system import MolecularSystem as JaxSystem
from qchem_rs_tpu_torch import (BasisSet, HartreeFockConfig, MolecularSystem, optimize_geometry,
                                unrestricted_hartree_fock)
from tests.torch_threads import one_torch_thread  # noqa: F401

DATA = os.path.join(os.path.dirname(__file__), "..", "data")


def _paths(mol):
    return (os.path.join(DATA, "mol", f"{mol}.json"),
            os.path.join(DATA, "basis", "STO-3G.json"))


@pytest.fixture(scope="module")
def hydrogen():
    """H2/STO-3G optimized by the port and by the JAX package (diag_rms
    1e-11, the default gtol)."""
    mpath, bpath = _paths("hydrogen")
    port = MolecularSystem.load(mpath, BasisSet.load(bpath))
    ours = optimize_geometry(port, HartreeFockConfig(epsilon=1e-11, max_iterations=300),
                             device="cpu")
    ref = jax_optimize.optimize_geometry(JaxSystem.load(mpath, JaxBasisSet.load(bpath)),
                                         JaxConfig(epsilon=1e-11, max_iterations=300))
    return ours, ref


def _bond(positions):
    return float(np.linalg.norm(positions[1] - positions[0]))


def test_h2_bond_matches_jax(hydrogen):
    ours, ref = hydrogen
    assert ours.converged and ref.converged
    assert abs(_bond(ours.positions) - _bond(ref.positions)) <= 1e-5  # Bohr
    assert abs(ours.energy - ref.energy) <= 1e-9  # Eh


def test_h2_textbook_bond(hydrogen):
    ours, _ = hydrogen
    assert abs(_bond(ours.positions) - 1.346) < 0.01
    assert ours.energy <= ours.energies[0] + 1e-12
    assert ours.gradient_norm < 3e-4
    assert ours.steps == len(ours.energies)


def test_oh_radical_open_shell_optimization():
    """UHF/STO-3G OH: the optimizer routes through uhf_gradient (odd
    electron count); the bond lands near 1.8 Bohr, the final max |g| under
    10 gtol, and the final gradient along the bond agrees with a central
    difference of the energy (h = 1e-3 Bohr) to 1e-6."""
    mpath, bpath = _paths("hydroxyl")
    port = MolecularSystem.load(mpath, BasisSet.load(bpath))
    cfg = HartreeFockConfig(epsilon=1e-12, max_iterations=400, spin_multiplicity=2)
    gtol = 1e-4
    res = optimize_geometry(port, cfg, gtol=gtol, max_steps=25, device="cpu")
    assert res.converged and res.gradient_norm < 10 * gtol
    assert res.energy <= res.energies[0] + 1e-12
    assert 1.5 < _bond(res.positions) < 2.2
    from qchem_rs_tpu_torch import uhf_gradient

    final = port.with_positions(res.positions)
    g = uhf_gradient(final, cfg, device="cpu")
    assert np.abs(g).max() < 10 * gtol
    h = 1e-3
    axis = (res.positions[1] - res.positions[0]) / _bond(res.positions)
    energies = []
    for sign in (1.0, -1.0):
        x = res.positions.copy()
        x[1] += sign * h * axis
        energies.append(unrestricted_hartree_fock(final.with_positions(x), cfg,
                                                  device="cpu").total_energy())
    fd = (energies[0] - energies[1]) / (2.0 * h)
    assert abs(float(g[1] @ axis) - fd) <= 1e-6  # Eh/Bohr
