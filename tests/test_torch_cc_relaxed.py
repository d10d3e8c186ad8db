"""Port parity, orbital-relaxed CCSD dipole: ``ccsd_relaxed_dipole`` on
water/STO-3G against the JAX package's (each package's own SCF at
diag_rms 1e-11; dipoles within 1e-8 a.u.), and against the central finite
difference of the port's CCSD total energy in a field of +-2e-4 a.u.
(which re-converges the orbitals, so it is the relaxed derivative); and the
port's ``ccsd --dipole --relaxed`` printing the JAX package's relaxed dipole
in the JAX CLI's format (``qchem_rs_tpu/cli.py``, ``cmd_ccsd``): the JAX CLI
itself would run both CC programs again for the same numbers."""

import dataclasses
import os

import numpy as np
import pytest

from qchem_rs_tpu import HartreeFockConfig as JaxConfig
from qchem_rs_tpu.models import cc_relaxed as jax_cc_relaxed
from qchem_rs_tpu.utils.basis import BasisSet as JaxBasisSet
from qchem_rs_tpu.utils.system import MolecularSystem as JaxSystem
from qchem_rs_tpu_torch import BasisSet, HartreeFockConfig, MolecularSystem, cli
from qchem_rs_tpu_torch.models import cc, cc_relaxed
from tests.test_torch_cli import _files, _run, _unsigned_zeros
from tests.torch_threads import one_torch_thread  # noqa: F401

DATA = os.path.join(os.path.dirname(__file__), "..", "data")
DIPOLE_TOL = 1e-8  # a.u., against the JAX package
FD_TOL = 5e-7  # a.u., against the finite field (the JAX package's own test bound)
CFG = dict(epsilon=1e-11, max_iterations=300)


def _systems(mol, basis):
    mpath = os.path.join(DATA, "mol", f"{mol}.json")
    bpath = os.path.join(DATA, "basis", f"{basis}.json")
    return (MolecularSystem.load(mpath, BasisSet.load(bpath)),
            JaxSystem.load(mpath, JaxBasisSet.load(bpath)))


@pytest.fixture(scope="module")
def water():
    port, jsys = _systems("water", "STO-3G")
    res = cc_relaxed.ccsd_relaxed_dipole(port, HartreeFockConfig(**CFG), cc_epsilon=1e-11,
                                         device="cpu")
    ref = jax_cc_relaxed.ccsd_relaxed_dipole(jsys, JaxConfig(**CFG),
                                             cc_epsilon=1e-11)
    return port, res, ref


def test_relaxed_dipole_matches_jax(water):
    _, res, ref = water
    assert np.max(np.abs(res.ccsd_dipole - ref.ccsd_dipole)) <= DIPOLE_TOL
    assert np.max(np.abs(res.ccsd_dipole_unrelaxed - ref.ccsd_dipole_unrelaxed)) <= DIPOLE_TOL
    assert np.max(np.abs(res.scf_dipole - ref.scf_dipole)) <= DIPOLE_TOL
    # each package ran its own SCF: compare what CC adds to it
    assert abs((res.ccsd_total_energy - res.scf_total_energy)
               - (ref.ccsd_total_energy - ref.scf_total_energy)) <= 1e-10
    assert res.z_residual <= 1e-6


def test_relaxed_dipole_matches_finite_field(water):
    port, res, _ = water
    h = 2e-4
    cfg = HartreeFockConfig(**CFG)

    def energy(field):
        return cc.ccsd(port, dataclasses.replace(cfg, electric_field=field), cc_epsilon=1e-11,
                       device="cpu").total_energy()

    ep, em = energy((0.0, 0.0, h)), energy((0.0, 0.0, -h))
    mu_fd = -(ep - em) / (2 * h)
    assert abs(res.ccsd_dipole[2] - mu_fd) < FD_TOL
    # the relaxation is a real correction, and all three dipoles agree to 0.1 a.u.
    assert np.max(np.abs(res.ccsd_dipole - res.ccsd_dipole_unrelaxed)) > 1e-5
    assert np.max(np.abs(res.ccsd_dipole - res.scf_dipole)) < 0.1


def test_relaxed_dipole_cli_prints_the_jax_lines(water, capsys):
    _, _, ref = water
    argv = ["ccsd", *_files("water"), "--epsilon", "1e-11", "--max-iterations", "300",
            "--cc-epsilon", "1e-11", "--dipole", "--relaxed"]
    rc, out = _run(cli.main, argv, capsys, ("--device", "cpu"))
    d = ref.ccsd_dipole
    want = (f"ccsd dipole (relaxed, a.u.): [{d[0]: .6f}, {d[1]: .6f}, {d[2]: .6f}]  "
            f"|mu| = {np.linalg.norm(d):.6f} "
            f"(unrelaxed {np.linalg.norm(ref.ccsd_dipole_unrelaxed):.6f})")
    assert rc == 0 and _unsigned_zeros(out[-1]) == _unsigned_zeros(want)
