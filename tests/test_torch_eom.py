"""Port parity, EOM-CCSD: the port's nonsymmetric Davidson against the JAX
package's on a seeded matrix (1e-12 relative); the determinant tier
(``eom_ccsd``, ``ip_eom_ccsd``, ``ea_eom_ccsd``, ``eom_ccsd_properties``) on
water/STO-3G against the JAX package's (each package's own SCF at diag_rms
1e-10): excitation energies within 1e-8 Eh, dipoles and strengths within
1e-8; the matrix-free tier (``eom_ccsd_davidson``, spinorbital and spatial,
each with its left solve) against the JAX package's determinant tier and,
spinorbital, against the JAX package's own ``eom_ccsd_davidson(left=True)``,
every root within the Davidson tol (1e-7); ``eom_ccsd_transition_moments``
against the JAX package's determinant tier at the JAX package's own test
bounds (1e-6 for roots, 1e-5 for strengths); and on H2, where EOM-CCSD is
exact, every root against the FCI spectrum."""

import os

import numpy as np
import pytest
import torch

from qchem_rs_tpu import HartreeFockConfig as JaxConfig
from qchem_rs_tpu.models import eom as jax_eom
from qchem_rs_tpu.utils.basis import BasisSet as JaxBasisSet
from qchem_rs_tpu.utils.system import MolecularSystem as JaxSystem
from qchem_rs_tpu_torch import BasisSet, HartreeFockConfig, MolecularSystem
from qchem_rs_tpu_torch.models import eom, fci
from tests.torch_threads import one_torch_thread  # noqa: F401

DATA = os.path.join(os.path.dirname(__file__), "..", "data")
DENSE_TOL = 1e-8  # Eh (dense excitation energies), a.u. (dipoles, strengths)
DAVIDSON_TOL = 1e-7
STEP_RTOL = 1e-12
CFG = dict(epsilon=1e-10, max_iterations=100)  # the JAX CLI's and tests' SCF


def _systems(mol, basis):
    mpath = os.path.join(DATA, "mol", f"{mol}.json")
    bpath = os.path.join(DATA, "basis", f"{basis}.json")
    return (MolecularSystem.load(mpath, BasisSet.load(bpath)),
            JaxSystem.load(mpath, JaxBasisSet.load(bpath)))


def test_davidson_nonsym_matches_jax():
    """A seeded, mildly nonsymmetric matrix with a real spectrum: both
    solvers find the same lowest three eigenvalues, those of numpy's eig."""
    rng = np.random.default_rng(17)
    n = 90
    S = np.eye(n) + 0.05 * rng.standard_normal((n, n)) / np.sqrt(n)
    A = S @ np.diag(np.linspace(0.3, 5.0, n)) @ np.linalg.inv(S)  # real spectrum
    d = np.diag(A).copy()
    w_ref, _, ok_ref = jax_eom._davidson_nonsym_lowest(
        lambda X: np.asarray(X) @ A.T, d, 3, in_subspace=lambda B: B, tol=1e-10)
    At = torch.as_tensor(A)
    w, X, ok = eom._davidson_nonsym_lowest(lambda X: X @ At.T, torch.as_tensor(d), 3,
                                           in_subspace=lambda B: B, tol=1e-10)
    exact = np.sort(np.linalg.eigvals(A).real)[:3]
    assert ok and ok_ref
    assert np.max(np.abs(w - w_ref)) <= STEP_RTOL * np.max(np.abs(w_ref))
    assert np.max(np.abs(w - exact)) <= 1e-10
    assert torch.linalg.norm(At @ X - X * torch.as_tensor(w)) <= 1e-9


@pytest.fixture(scope="module")
def water():
    port, jsys = _systems("water", "STO-3G")
    ref = jax_eom.eom_ccsd_properties(jsys, JaxConfig(**CFG), nstates=8, cc_epsilon=1e-11)
    det = eom.eom_ccsd_properties(port, HartreeFockConfig(**CFG), nstates=8, cc_epsilon=1e-11,
                                  device="cpu")
    return port, jsys, ref, det


def test_eom_properties_match_jax(water):
    _, _, ref, det = water
    assert det.dimension == ref.dimension
    assert np.max(np.abs(det.excitation_energies - ref.excitation_energies)) <= DENSE_TOL
    assert abs(det.ccsd_total_energy - ref.ccsd_total_energy) <= 1e-10
    assert np.max(np.abs(det.ground_state_dipole - ref.ground_state_dipole)) <= DENSE_TOL
    assert np.max(np.abs(det.transition_strengths.sum(axis=1)
                         - ref.transition_strengths.sum(axis=1))) <= DENSE_TOL
    assert np.max(np.abs(det.oscillator_strengths - ref.oscillator_strengths)) <= DENSE_TOL


def test_eom_ccsd_matches_jax(water):
    port, jsys, ref, _ = water
    res = eom.eom_ccsd(port, HartreeFockConfig(**CFG), nstates=6, device="cpu")
    want = jax_eom.eom_ccsd(jsys, JaxConfig(**CFG), nstates=6)
    assert (res.dimension, res.fci_dimension) == (want.dimension, want.fci_dimension)
    assert np.max(np.abs(res.excitation_energies - want.excitation_energies)) <= DENSE_TOL
    assert abs(res.ccsd_total_energy - want.ccsd_total_energy) <= 1e-10
    assert res.amplitude_residual <= 1e-8


@pytest.mark.parametrize("kind", ["ip", "ea"])
def test_ip_ea_match_jax(water, kind):
    port, jsys, _, _ = water
    fn, ref_fn = getattr(eom, f"{kind}_eom_ccsd"), getattr(jax_eom, f"{kind}_eom_ccsd")
    res = fn(port, HartreeFockConfig(**CFG), nstates=3, device="cpu")
    ref = ref_fn(jsys, JaxConfig(**CFG), nstates=3)
    assert res.kind == kind and res.dimension == ref.dimension
    assert np.max(np.abs(res.energies - ref.energies)) <= DENSE_TOL
    assert abs(res.koopmans - ref.koopmans) <= DENSE_TOL


@pytest.mark.parametrize("formulation", ["spinorbital", "spatial"])
def test_matrix_free_matches_the_determinant_tier(water, formulation):
    """Spinorbital roots, right and left, are the lowest of the exact
    spectrum and those of the JAX package's matrix-free solver (four of
    them: at three the JAX package's left solve does not converge on this
    system, as its split triplet cuts through the block); spatial (singlet)
    roots each lie in the exact spectrum, and so do their left roots."""
    port, jsys, ref, _ = water
    nstates = 4 if formulation == "spinorbital" else 3
    kw = dict(nstates=nstates, formulation=formulation, tol=DAVIDSON_TOL, cc_epsilon=1e-11,
              left=True)
    res = eom.eom_ccsd_davidson(port, HartreeFockConfig(**CFG), device="cpu", **kw)
    exact = ref.excitation_energies
    for roots in (res.excitation_energies, res.left_excitation_energies):
        if formulation == "spinorbital":
            assert np.max(np.abs(roots - exact[:nstates])) <= DAVIDSON_TOL
        else:
            for w in roots:
                assert np.min(np.abs(exact - w)) <= DAVIDSON_TOL
    if formulation == "spinorbital":
        want = jax_eom.eom_ccsd_davidson(jsys, JaxConfig(**CFG), **kw)
        assert np.max(np.abs(res.excitation_energies - want.excitation_energies)) <= DAVIDSON_TOL
        assert np.max(np.abs(res.left_excitation_energies
                             - want.left_excitation_energies)) <= DAVIDSON_TOL
        assert res.dimension == want.dimension
    # the determinant tier's <0|Hbar|0> holds the exact HF energy of the
    # final orbitals, the matrix-free tier the SCF's reported one: ~1e-10 apart
    assert abs(res.ccsd_total_energy - ref.ccsd_total_energy) <= 1e-9


def test_transition_moments_match_the_determinant_tier(water):
    """The matrix-free transition moments against the JAX package's exact
    determinant-space strengths, at the JAX package's own test bounds."""
    port, _, ref, det = water
    prod = eom.eom_ccsd_transition_moments(port, HartreeFockConfig(**CFG), nstates=4, tol=1e-8,
                                           cc_epsilon=1e-11, device="cpu")
    assert np.max(np.abs(prod.excitation_energies - ref.excitation_energies[:4])) <= 1e-6
    assert np.max(np.abs(prod.transition_strengths.sum(axis=1)
                         - ref.transition_strengths[:4].sum(axis=1))) <= 1e-5
    assert np.max(np.abs(prod.oscillator_strengths - ref.oscillator_strengths[:4])) <= 1e-5
    assert np.max(np.abs(prod.ground_state_dipole - det.ground_state_dipole)) <= 1e-6


def test_h2_eom_roots_are_the_fci_spectrum():
    port, _ = _systems("hydrogen", "6-31G")
    cfg = HartreeFockConfig(**CFG)
    res = eom.eom_ccsd(port, cfg, nstates=5, device="cpu")
    spectrum = fci.fci(port, cfg, nroots=8, device="cpu").total_energies
    assert abs(res.ccsd_total_energy - spectrum[0]) <= 1e-9
    assert np.max(np.abs(res.excitation_energies - (spectrum[1:6] - spectrum[0]))) <= 1e-8


def test_eom_guards():
    oh, _ = _systems("hydroxyl", "STO-3G")
    with pytest.raises(ValueError, match="closed-shell"):
        eom.eom_ccsd(oh, HartreeFockConfig(spin_multiplicity=2), device="cpu")
    water_sys, _ = _systems("water", "STO-3G")
    with pytest.raises(ValueError, match="unknown formulation"):
        eom.eom_ccsd_davidson(water_sys, formulation="bogus", device="cpu")
    with pytest.raises(ValueError, match="max_dim"):
        eom.eom_ccsd(water_sys, HartreeFockConfig(**CFG), max_dim=100, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            eom.eom_ccsd(water_sys)
