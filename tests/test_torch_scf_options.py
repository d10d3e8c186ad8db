"""Port parity, SCF options: level shifting and a uniform external field in
RHF and UHF through the in-core, pair and direct Fock modes, against the
unshifted fixed point, against the JAX package's run with the same options
(from the same starting density), and the field's central difference
against ``dipole_moment``."""

import os

import jax.numpy as jnp
import numpy as np
import pytest

from qchem_rs_tpu import HartreeFockConfig as JaxConfig
from qchem_rs_tpu import restricted_hartree_fock as jax_rhf
from qchem_rs_tpu import unrestricted_hartree_fock as jax_uhf
from qchem_rs_tpu.models import scf as jax_scf
from qchem_rs_tpu.ops import one_electron as jax_one_electron
from qchem_rs_tpu.utils.basis import BasisSet as JaxBasisSet
from qchem_rs_tpu.utils.system import MolecularSystem as JaxSystem
from qchem_rs_tpu_torch import (BasisSet, HartreeFockConfig, MolecularSystem,
                                restricted_hartree_fock, unrestricted_hartree_fock)
from qchem_rs_tpu_torch.models import properties, scf
from tests.torch_threads import one_torch_thread  # noqa: F401

DATA = os.path.join(os.path.dirname(__file__), "..", "data")
MODES = ["incore", "pair", "direct"]
SHIFT = 0.3
FIELD = (0.0, 0.0, 1e-3)


def _paths(mol):
    return os.path.join(DATA, "mol", f"{mol}.json"), os.path.join(DATA, "basis", "STO-3G.json")


def _system(mol):
    mpath, bpath = _paths(mol)
    return MolecularSystem.load(mpath, BasisSet.load(bpath))


@pytest.fixture(scope="module")
def water():
    """The port's unshifted RHF on water/STO-3G and the JAX package's
    shifted and finite-field runs, all at diag_rms 1e-10."""
    jsys = JaxSystem.load(*_paths("water")[:1], JaxBasisSet.load(_paths("water")[1]))
    base = restricted_hartree_fock(_system("water"), HartreeFockConfig(epsilon=1e-10), device="cpu")
    shifted = jax_rhf(jsys, JaxConfig(epsilon=1e-10, level_shift=SHIFT))
    field = jax_rhf(jsys, JaxConfig(epsilon=1e-10, electric_field=FIELD))
    return base, shifted, field


@pytest.fixture(scope="module")
def hydroxyl():
    """UHF on the OH doublet/STO-3G: the JAX package's Hückel guess (its pi
    pair is degenerate, and the two packages' eigensolvers rotate it
    differently, so both start from this density), the port's unshifted
    run and the JAX package's shifted and finite-field runs from it, at
    diag_rms 1e-12 (at 1e-10 the two packages stop some 1e-9 Eh apart)."""
    mpath, bpath = _paths("hydroxyl")
    jsys = JaxSystem.load(mpath, JaxBasisSet.load(bpath))
    pos = jnp.asarray(jsys.positions)
    S = jax_one_electron.overlap(jsys, pos)
    H = jax_one_electron.kinetic(jsys, pos) + jax_one_electron.nuclear(jsys, pos)
    X = jax_scf.lowdin_x(S)
    nocc = jax_scf.electron_counts(jsys.n_electrons(0), 2)
    D0 = np.stack([np.asarray(jax_scf.huckel_guess(H, S, X, k, scale=1.0)) for k in nocc])
    cfg = dict(epsilon=1e-12, max_iterations=300, spin_multiplicity=2)
    base = unrestricted_hartree_fock(_system("hydroxyl"), HartreeFockConfig(**cfg),
                                     density_guess=D0, device="cpu")
    shifted = jax_uhf(jsys, JaxConfig(**cfg, level_shift=SHIFT), density_guess=D0)
    field = jax_uhf(jsys, JaxConfig(**cfg, electric_field=FIELD), density_guess=D0)
    return D0, cfg, base, shifted, field


@pytest.mark.parametrize("mode", MODES)
def test_level_shifted_rhf(water, mode):
    base, ref, _ = water
    out = restricted_hartree_fock(
        _system("water"), HartreeFockConfig(epsilon=1e-10, fock_mode=mode, level_shift=SHIFT),
        device="cpu")
    assert base.converged and ref.converged and out.converged
    assert abs(out.total_energy() - base.total_energy()) <= 1e-8
    assert abs(out.total_energy() - ref.total_energy()) <= 1e-9


@pytest.mark.parametrize("mode", MODES)
def test_level_shifted_uhf(hydroxyl, mode):
    D0, cfg, base, ref, _ = hydroxyl
    out = unrestricted_hartree_fock(
        _system("hydroxyl"), HartreeFockConfig(**cfg, fock_mode=mode, level_shift=SHIFT),
        density_guess=D0, device="cpu")
    assert base.converged and ref.converged and out.converged
    assert abs(out.total_energy() - base.total_energy()) <= 1e-8
    assert abs(out.total_energy() - ref.total_energy()) <= 1e-9


@pytest.mark.parametrize("mode", MODES)
def test_finite_field_rhf(water, mode):
    _, _, ref = water
    out = restricted_hartree_fock(
        _system("water"), HartreeFockConfig(epsilon=1e-10, fock_mode=mode, electric_field=FIELD),
        device="cpu")
    assert ref.converged and out.converged
    assert abs(out.total_energy() - ref.total_energy()) <= 1e-9
    assert abs(out.nuclear_repulsion - ref.nuclear_repulsion) <= 1e-12


@pytest.mark.parametrize("mode", MODES)
def test_finite_field_uhf(hydroxyl, mode):
    D0, cfg, _, _, ref = hydroxyl
    out = unrestricted_hartree_fock(
        _system("hydroxyl"), HartreeFockConfig(**cfg, fock_mode=mode, electric_field=FIELD),
        density_guess=D0, device="cpu")
    assert ref.converged and out.converged
    assert abs(out.total_energy() - ref.total_energy()) <= 1e-9


def test_field_central_difference_is_the_dipole(water):
    # dE/dF_z = -mu_z: the field's central difference against the dipole of
    # the field-free density
    base = water[0]
    system = _system("water")
    F = FIELD[2]
    E = [restricted_hartree_fock(system, HartreeFockConfig(epsilon=1e-10, electric_field=(0, 0, f)),
                                 device="cpu").total_energy() for f in (F, -F)]
    mu = properties.dipole_moment(system, base.density, "cpu")
    assert abs(-(E[0] - E[1]) / (2 * F) - mu[2]) <= 1e-5


def test_shifted_solve_matches_jax():
    rng = np.random.default_rng(5)
    n = 6
    A = rng.normal(size=(n, n))
    S = A @ A.T / n + np.eye(n)
    F = rng.normal(size=(n, n))
    F = F + F.T
    C = rng.normal(size=(n, 2))
    D = C @ C.T
    import torch

    X = scf.lowdin_x(torch.tensor(S))
    C_out, w = scf.shifted_solve_fock(torch.tensor(F), torch.tensor(D), X, torch.tensor(S), 0.5)
    C_ref, w_ref = jax_scf.shifted_solve_fock(jnp.asarray(F), jnp.asarray(D), jax_scf.lowdin_x(
        jnp.asarray(S)), jnp.asarray(S), 0.5)
    np.testing.assert_allclose(w.numpy(), np.asarray(w_ref), rtol=0, atol=1e-12)
    np.testing.assert_allclose(np.abs(C_out.numpy()), np.abs(np.asarray(C_ref)), rtol=0, atol=1e-10)
