"""Port parity, spherical AOs: ``qchem_rs_tpu_torch.ops.spherical`` and the
spherical system against the JAX package's, the pair-space projection
against the dense one, spherical RHF against the JAX package's value, the
Fock modes and UHF against each other, the SAD cache, interop and the CLI
flag. The comparisons that compile JAX integral programs sit beside their
Cartesian twins, whose programs they share: spherical S/T/V in
tests/test_torch_integrals.py, the spherical finish and J/K in
tests/test_torch_eri.py, the spherical SAD atoms in tests/test_torch_sad.py."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from qchem_rs_tpu.ops import spherical as jax_spherical
from qchem_rs_tpu.utils.basis import BasisSet as JaxBasisSet
from qchem_rs_tpu.utils.system import MolecularSystem as JaxSystem
from qchem_rs_tpu_torch import (
    BasisSet,
    HartreeFockConfig,
    MolecularSystem,
    restricted_hartree_fock,
    unrestricted_hartree_fock,
)
from qchem_rs_tpu_torch.cli import main as cli_main
from qchem_rs_tpu_torch.models import sad
from qchem_rs_tpu_torch.ops import one_electron, spherical
from qchem_rs_tpu_torch.ops.angular import ncart
from qchem_rs_tpu_torch.ops.eri_tiled import TiledEriEngine
from qchem_rs_tpu_torch.utils import interop
from tests.torch_threads import one_torch_thread  # noqa: F401

DATA = os.path.join(os.path.dirname(__file__), "..", "data")


def _paths(basis, mol):
    return os.path.join(DATA, "mol", f"{mol}.json"), os.path.join(DATA, "basis", f"{basis}.json")


def _system(basis, mol, spherical=True):
    mpath, bpath = _paths(basis, mol)
    return MolecularSystem.load(mpath, BasisSet.load(bpath), spherical=spherical)


def _jax_system(basis, mol):
    mpath, bpath = _paths(basis, mol)
    return JaxSystem.load(mpath, JaxBasisSet.load(bpath), spherical=True)


def _rel(out, ref):
    ref = np.asarray(ref)
    return np.abs(np.asarray(out) - ref).max() / max(np.abs(ref).max(), 1.0)


@pytest.mark.parametrize("l", range(5))
def test_cart_to_sph_matches_jax(l):
    out, ref = spherical.cart_to_sph(l), jax_spherical.cart_to_sph(l)
    assert out.shape == ref.shape == (ncart(l), spherical.nsph(l) if l >= 2 else ncart(l))
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-14)


def test_system_transform_and_sizes_match_jax():
    system, jsys = _system("6-31G_st", "water"), _jax_system("6-31G_st", "water")
    np.testing.assert_allclose(system.sph_T, jax_spherical.system_transform(jsys), rtol=0, atol=1e-14)
    assert (system.n_basis(), system.n_basis_cart()) == (jsys.n_basis(), jsys.n_basis_cart()) == (18, 19)
    np.testing.assert_array_equal(system.ao_atom_indices(), jsys.ao_atom_indices())
    cart = _system("6-31G_st", "water", spherical=False)
    assert cart.sph_T is None and cart.n_basis() == 19


def test_spherical_pair_matrix_is_the_dense_projection():
    # the pair-space projection equals the four-index one of the Cartesian
    # tensor, which the port never forms on its path
    system = _system("6-31G_st", "water")
    cart = _system("6-31G_st", "water", spherical=False)
    ec = TiledEriEngine(cart, 0.0, device="cpu")
    e4c = ec.finish_eri(ec.build())
    T = torch.tensor(system.sph_T)
    ref = torch.einsum("pqrs,pi,qj,rk,sl->ijkl", e4c, T, T, T, T).numpy()
    es = TiledEriEngine(system, 0.0, device="cpu")
    V2s = es.v2s_mirrored(es.build())
    assert V2s.shape == (es.sph_layout.Ms,) * 2
    pmap = torch.as_tensor(es.sph_layout.pmap)
    out = V2s[pmap][:, pmap].reshape((18,) * 4).numpy()
    assert np.abs(out - ref).max() <= 1e-13
    e4 = es.finish_eri(es.build()).numpy()
    assert np.abs(e4 - ref).max() <= 1e-13


def test_spherical_sad_cache_keeps_the_conventions_apart(tmp_path, monkeypatch):
    monkeypatch.setenv(sad.CACHE_ENV, str(tmp_path))
    basis = BasisSet.load(_paths("6-31G_st", "water")[1])
    assert sad._element_fingerprint(basis, 8, True) != sad._element_fingerprint(basis, 8, False)
    system = _system("6-31G_st", "water")
    D = sad.sad_guess(system)
    assert D.shape == (18, 18)
    assert len(list(tmp_path.glob("*.npy"))) == 2  # H and O, spherical
    S = one_electron.overlap(system, "cpu").numpy()
    assert abs(np.sum(D * S) - 10.0) < 0.05


#: water/cc-pVDZ spherical, the JAX package's in-core RHF on the CPU at
#: diag_rms 1e-10 from the Hückel guess (18 iterations; its run takes some
#: 80 s of one core, mostly compiling, so the value is pinned here: the
#: command is in PERF.md)
JAX_WATER_CCPVDZ_SPH = -76.02679869798291


def test_spherical_rhf_water_ccpvdz_matches_jax():
    out = restricted_hartree_fock(_system("cc-pVDZ", "water"),
                                  HartreeFockConfig(epsilon=1e-10), device="cpu")
    assert out.converged
    assert out.orbital_energies.shape == (24,) and out.density.shape == (24, 24)
    assert abs(out.total_energy() - JAX_WATER_CCPVDZ_SPH) <= 1e-8
    assert abs(out.total_energy() - -76.02680) < 5e-6  # tests/test_spherical.py's literature value


@pytest.mark.parametrize("mode", ["pair", "direct"])
def test_spherical_rhf_modes_match_incore_water_631gs(mode, tmp_path, monkeypatch):
    monkeypatch.setenv(sad.CACHE_ENV, str(tmp_path))
    # the pair mode runs its own trajectory from SAD; the direct mode (a
    # whole integral pass each iteration, slow on the CPU) starts from the
    # in-core fixed point and must stay on it
    cfg = dict(epsilon=1e-11, initial_guess="sad")
    system = _system("6-31G_st", "water")
    ref = restricted_hartree_fock(system, HartreeFockConfig(**cfg), device="cpu")
    guess = ref.density if mode == "direct" else None
    out = restricted_hartree_fock(system, HartreeFockConfig(fock_mode=mode, **cfg),
                                  density_guess=guess, device="cpu")
    assert out.converged and abs(out.total_energy() - ref.total_energy()) <= 1e-9


@pytest.fixture(scope="module")
def oh_uhf_incore(tmp_path_factory):
    system = _system("6-31G_st", "hydroxyl")
    cfg = HartreeFockConfig(epsilon=1e-11, max_iterations=300, spin_multiplicity=2,
                            initial_guess="sad")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv(sad.CACHE_ENV, str(tmp_path_factory.mktemp("sad")))
        return system, cfg, unrestricted_hartree_fock(system, cfg, device="cpu")


@pytest.mark.parametrize("mode", ["pair", "direct"])
def test_spherical_uhf_oh_modes_agree(oh_uhf_incore, mode, tmp_path, monkeypatch):
    monkeypatch.setenv(sad.CACHE_ENV, str(tmp_path))
    # as for RHF: pair from SAD, direct from the in-core fixed point
    system, cfg, ref = oh_uhf_incore
    cfg = dataclasses.replace(cfg, fock_mode=mode)
    guess = ref.density if mode == "direct" else None
    out = unrestricted_hartree_fock(system, cfg, density_guess=guess, device="cpu")
    assert ref.converged and out.converged
    assert out.density.shape == (2, 16, 16)
    assert abs(out.total_energy() - ref.total_energy()) <= 1e-9


def test_spherical_density_carries_over_from_jax():
    # a JAX spherical system's arrays build the port's spherical system, and
    # a working-basis density goes across as it is
    jsys = _jax_system("6-31G_st", "water")
    system = interop.system_from_numpy([a.ordinal for a in jsys.atoms], jsys.positions,
                                       BasisSet.load(_paths("6-31G_st", "water")[1]),
                                       spherical=jsys.spherical)
    assert system.spherical and system.n_basis() == jsys.n_basis()
    D = interop.density_guess(np.eye(18), system.n_basis(), 1, "cpu")
    assert D.shape == (18, 18)
    with pytest.raises(ValueError, match="shape"):
        interop.density_guess(np.eye(19), system.n_basis(), 1, "cpu")


@pytest.mark.parametrize("command", ["rhf", "uhf"])
def test_cli_spherical_flag(capsys, command):
    mpath, bpath = _paths("STO-3G" if command == "rhf" else "6-31G_st",
                          "water" if command == "rhf" else "hydroxyl")
    args = [command, "-b", bpath, "-m", mpath, "--spherical", "--device", "cpu", "--epsilon", "1e-9"]
    if command == "uhf":
        args += ["--spin-multiplicity", "2", "--max-iterations", "300"]
    assert cli_main(args) == 0
    lines = capsys.readouterr().out.splitlines()
    if command == "rhf":  # STO-3G has no d shell: the same energy as Cartesian
        assert lines[3] == "hartree fock energy: -74.963"
    else:
        assert lines[3] == "hartree fock energy: -75.381"
        assert lines[6].startswith("spin expectation <S^2>: 0.75")
