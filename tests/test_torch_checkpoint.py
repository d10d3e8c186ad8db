"""Port parity, checkpoints: the port's ``ScfCheckpoint`` round trip, and
checkpoints moving between the two packages (the same ``.npz`` keys): a
run resumed from the other package's checkpoint converges in at most two
iterations to the same energy."""

import os

import numpy as np
import pytest

from qchem_rs_tpu import HartreeFockConfig as JaxConfig
from qchem_rs_tpu import restricted_hartree_fock as jax_rhf
from qchem_rs_tpu import unrestricted_hartree_fock as jax_uhf
from qchem_rs_tpu.utils import checkpoint as jax_checkpoint
from qchem_rs_tpu.utils.basis import BasisSet as JaxBasisSet
from qchem_rs_tpu.utils.system import MolecularSystem as JaxSystem
from qchem_rs_tpu_torch import (BasisSet, HartreeFockConfig, MolecularSystem, ScfCheckpoint,
                                restricted_hartree_fock, unrestricted_hartree_fock)
from qchem_rs_tpu_torch.utils import checkpoint
from tests.torch_threads import one_torch_thread  # noqa: F401

DATA = os.path.join(os.path.dirname(__file__), "..", "data")
PATHS = (os.path.join(DATA, "mol", "water.json"), os.path.join(DATA, "basis", "STO-3G.json"))


@pytest.fixture(scope="module")
def systems():
    port = MolecularSystem.load(PATHS[0], BasisSet.load(PATHS[1]))
    jsys = JaxSystem.load(PATHS[0], JaxBasisSet.load(PATHS[1]))
    return port, jsys


def _same(a, b) -> None:
    assert (a.kind, a.electronic_energy, a.iterations, a.basis_name) == (
        b.kind, b.electronic_energy, b.iterations, b.basis_name)
    for key in ("density", "coefficients", "orbital_energies", "positions"):
        np.testing.assert_array_equal(getattr(a, key), getattr(b, key))


@pytest.mark.parametrize("kind", ["rhf", "uhf"])
def test_port_round_trip(systems, tmp_path, kind):
    port, _ = systems
    cfg = HartreeFockConfig(epsilon=1e-8)
    if kind == "rhf":
        ck = checkpoint.from_rhf_output(restricted_hartree_fock(port, cfg, device="cpu"), port)
    else:
        ck = checkpoint.from_uhf_output(unrestricted_hartree_fock(port, cfg, device="cpu"), port)
    path = tmp_path / f"{kind}.npz"
    ck.save(path)
    back = ScfCheckpoint.load(path)
    _same(back, ck)
    assert back.kind == kind and back.basis_name == "STO-3G"
    with np.load(path) as z:
        assert sorted(z.files) == sorted(
            ["kind", "density", "coefficients", "orbital_energies", "electronic_energy",
             "iterations", "positions", "basis_name"])


def test_jax_checkpoint_resumes_in_the_port(systems, tmp_path):
    port, jsys = systems
    ref = jax_rhf(jsys, JaxConfig(epsilon=1e-10))
    path = tmp_path / "jax.npz"
    jax_checkpoint.from_rhf_output(ref, jsys).save(path)
    ck = ScfCheckpoint.load(path)
    _same(ck, jax_checkpoint.ScfCheckpoint.load(path))
    out = restricted_hartree_fock(port, HartreeFockConfig(epsilon=1e-8), density_guess=ck.density,
                                  device="cpu")
    assert out.converged and out.iterations <= 2
    assert abs(out.total_energy() - ref.total_energy()) <= 1e-9


def test_port_checkpoint_resumes_in_jax(systems, tmp_path):
    port, jsys = systems
    out = restricted_hartree_fock(port, HartreeFockConfig(epsilon=1e-10), device="cpu")
    path = tmp_path / "port.npz"
    checkpoint.from_rhf_output(out, port).save(path)
    ck = jax_checkpoint.ScfCheckpoint.load(path)
    ref = jax_rhf(jsys, JaxConfig(epsilon=1e-8), density_guess=ck.density)
    assert ref.converged and ref.iterations <= 2
    assert abs(ref.total_energy() - out.total_energy()) <= 1e-9


def test_uhf_checkpoints_move_both_ways(systems, tmp_path):
    port, jsys = systems
    # UHF's diag_rms stop (the spin mean, halved) leaves more of the tail
    # than RHF's: the source run goes to 1e-12, the resumed ones to 1e-10
    cfg = dict(epsilon=1e-12, charge=1, spin_multiplicity=2, max_iterations=300)
    out = unrestricted_hartree_fock(port, HartreeFockConfig(**cfg), device="cpu")
    path = tmp_path / "port_uhf.npz"
    checkpoint.from_uhf_output(out, port).save(path)
    ref = jax_uhf(jsys, JaxConfig(**{**cfg, "epsilon": 1e-10}),
                  density_guess=jax_checkpoint.ScfCheckpoint.load(path).density)
    assert ref.converged and ref.iterations <= 2
    assert abs(ref.total_energy() - out.total_energy()) <= 1e-9
    path = tmp_path / "jax_uhf.npz"
    jax_checkpoint.from_uhf_output(ref, jsys).save(path)
    back = unrestricted_hartree_fock(port, HartreeFockConfig(**{**cfg, "epsilon": 1e-10}),
                                     density_guess=ScfCheckpoint.load(path).density, device="cpu")
    assert back.converged and back.iterations <= 2
    assert abs(back.total_energy() - out.total_energy()) <= 1e-9
