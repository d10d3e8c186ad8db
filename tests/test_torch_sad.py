"""Port parity, the SAD guess: ``qchem_rs_tpu_torch.models.sad`` (atoms
solved on the CPU from the port's own integrals) against the JAX package's
``qchem_rs_tpu.models.sad``, and its disk cache. Both packages' caches live
in temporary directories."""

import os

import numpy as np
import pytest

from qchem_rs_tpu.models import sad as jax_sad
from qchem_rs_tpu.utils.basis import BasisSet as JaxBasisSet
from qchem_rs_tpu.utils.system import MolecularSystem as JaxSystem
from qchem_rs_tpu_torch import BasisSet, MolecularSystem
from qchem_rs_tpu_torch.models import sad
from qchem_rs_tpu_torch.ops import one_electron
from tests.torch_threads import one_torch_thread  # noqa: F401

DATA = os.path.join(os.path.dirname(__file__), "..", "data")
BASES = ("STO-3G", "cc-pVDZ")
ELEMENTS = (1, 6, 8)


def _basis_path(name):
    return os.path.join(DATA, "basis", f"{name}.json")


@pytest.mark.parametrize("w,n", [
    ([-1.0, -0.5, -0.5, -0.5, 0.2], 6),  # a degenerate triple shares 4 electrons
    ([-2.0, -1.0], 4),  # full
    ([-2.0, -1.0, 0.0], 0),  # empty
    ([-3.0, -1.0, -1.0 + 5e-7, -1.0 + 1e-6, 0.5], 5),  # a near-degenerate ladder
    ([-1.0, -0.4, -0.4, -0.4, -0.1, -0.1, -0.1, -0.1, -0.1], 9),  # s, p and d groups
])
def test_fractional_occupations_match_jax(w, n):
    w = np.asarray(w)
    out = sad._fractional_occupations(w, n)
    np.testing.assert_array_equal(out, jax_sad._fractional_occupations(w, n))
    assert abs(out.sum() - n) < 1e-12


@pytest.fixture(scope="module")
def jax_cache(tmp_path_factory):
    """A disk cache of the JAX package's own, and a function that gives its
    densities of H, C and O in one basis, solved by its
    ``compute_atomic_density`` at the first request for that basis (so
    that a worker with STO-3G cases only compiles no d-shell integrals)."""
    path = tmp_path_factory.mktemp("jax_sad")
    solved = {}

    def densities(basis):
        if basis not in solved:
            with pytest.MonkeyPatch.context() as mp:
                mp.setenv("QCHEM_SAD_CACHE", str(path))
                solved[basis] = jax_sad._atomic_densities(
                    JaxBasisSet.load(_basis_path(basis)), list(ELEMENTS), False)
        return solved[basis]

    return path, densities


@pytest.mark.parametrize("basis", BASES)
@pytest.mark.parametrize("Z", ELEMENTS)
def test_atomic_density_matches_jax(jax_cache, basis, Z):
    ref = jax_cache[1](basis)[Z]
    out = sad.compute_atomic_density(BasisSet.load(_basis_path(basis)), Z)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-8)


@pytest.mark.parametrize("Z", ELEMENTS)
def test_spherical_atomic_density_matches_jax(jax_cache, monkeypatch, Z):
    # cc-pVDZ in spherical AOs (5d): the JAX package solves the atom from
    # its Cartesian integrals projected with the atom's transform, with the
    # programs that its Cartesian cc-pVDZ atoms compiled
    jax_cache[1]("cc-pVDZ")
    monkeypatch.setenv("QCHEM_SAD_CACHE", str(jax_cache[0]))
    jbasis = JaxBasisSet.load(_basis_path("cc-pVDZ"))
    ref = jax_sad.compute_atomic_density(jbasis, Z, True)
    out = sad.compute_atomic_density(BasisSet.load(_basis_path("cc-pVDZ")), Z, spherical=True)
    assert out.shape == ref.shape == ((5, 5) if Z == 1 else (14, 14))
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-8)


def test_spherical_sad_guess_matches_jax(jax_cache, tmp_path, monkeypatch):
    jax_cache[1]("cc-pVDZ")
    path = os.path.join(DATA, "mol", "water.json")
    monkeypatch.setenv("QCHEM_SAD_CACHE", str(tmp_path / "jax"))
    monkeypatch.setenv(sad.CACHE_ENV, str(tmp_path / "port"))
    jsys = JaxSystem.load(path, JaxBasisSet.load(_basis_path("cc-pVDZ")), spherical=True)
    ref = jax_sad.sad_guess(jsys, 0)
    out = sad.sad_guess(MolecularSystem.load(path, BasisSet.load(_basis_path("cc-pVDZ")),
                                             spherical=True))
    assert out.shape == ref.shape == (24, 24)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-8)


@pytest.mark.parametrize("charge", [0, 1])
def test_sad_guess_matches_jax(jax_cache, tmp_path, monkeypatch, charge):
    path = os.path.join(DATA, "mol", "water.json")
    monkeypatch.setenv("QCHEM_SAD_CACHE", str(jax_cache[0]))
    monkeypatch.setenv(sad.CACHE_ENV, str(tmp_path))
    ref = jax_sad.sad_guess(JaxSystem.load(path, JaxBasisSet.load(_basis_path("cc-pVDZ"))), charge)
    system = MolecularSystem.load(path, BasisSet.load(_basis_path("cc-pVDZ")))
    out = sad.sad_guess(system, charge)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-8)
    S = one_electron.overlap(system, "cpu").numpy()
    assert abs(float(np.sum(out * S)) - system.n_electrons(charge)) < 1e-6


def test_disk_cache_round_trip(tmp_path, monkeypatch):
    monkeypatch.setenv(sad.CACHE_ENV, str(tmp_path))
    basis = BasisSet.load(_basis_path("STO-3G"))
    first = sad._atomic_densities(basis, [1, 8])
    assert sorted(os.listdir(tmp_path)) == sorted(
        f"{sad._element_fingerprint(basis, Z)}.npy" for Z in (1, 8))

    def solver_must_not_run(*args):
        raise AssertionError("the cache missed")

    monkeypatch.setattr(sad, "compute_atomic_density", solver_must_not_run)
    again = sad._atomic_densities(basis, [1, 8])
    for Z in (1, 8):
        np.testing.assert_array_equal(first[Z], again[Z])


def test_cache_is_the_ports_own(monkeypatch):
    monkeypatch.delenv(sad.CACHE_ENV, raising=False)
    monkeypatch.delenv("QCHEM_SAD_CACHE", raising=False)
    basis = BasisSet.load(_basis_path("STO-3G"))
    jbasis = JaxBasisSet.load(_basis_path("STO-3G"))
    assert sad._element_fingerprint(basis, 8) != jax_sad._element_fingerprint(jbasis, 8, False)
    assert str(sad._disk_dir()) != jax_sad._disk_dir()
