"""Port parity, UHF: ``qchem_rs_tpu_torch.unrestricted_hartree_fock`` on the
CPU (every kernel through its plain twin) against the JAX package's
``unrestricted_hartree_fock``, the three Fock modes against each other, and
the ``uhf`` CLI.

OH's Hückel guess fills one of two degenerate pi orbitals for the beta
spin, and the two packages' eigensolvers pick different rotations of that
pair, so the parity runs start both packages from one density: the JAX
package's own Hückel guess, carried over as numpy."""

import dataclasses
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qchem_rs_tpu import HartreeFockConfig as JaxConfig
from qchem_rs_tpu import unrestricted_hartree_fock as jax_uhf
from qchem_rs_tpu.models import scf as jax_scf
from qchem_rs_tpu.models.properties import spin_expectation as jax_spin_expectation
from qchem_rs_tpu.ops import one_electron as jax_one_electron
from qchem_rs_tpu.utils.basis import BasisSet as JaxBasisSet
from qchem_rs_tpu.utils.system import MolecularSystem as JaxSystem
from qchem_rs_tpu_torch import BasisSet, HartreeFockConfig, MolecularSystem, cli
from qchem_rs_tpu_torch import unrestricted_hartree_fock
from qchem_rs_tpu_torch.models import scf, uhf
from qchem_rs_tpu_torch.models.sad import CACHE_ENV
from tests.torch_threads import one_torch_thread  # noqa: F401

DATA = os.path.join(os.path.dirname(__file__), "..", "data")


def _paths(basis, mol):
    return os.path.join(DATA, "mol", f"{mol}.json"), os.path.join(DATA, "basis", f"{basis}.json")


def _system(basis, mol):
    mpath, bpath = _paths(basis, mol)
    return MolecularSystem.load(mpath, BasisSet.load(bpath))


# (basis, molecule, multiplicity, epsilon): the OH doublet's diag_rms tail
# below 1e-8 moves by a few passes with rounding, so it is held at 1e-8
JAX_CASES = {"oh": ("6-31G", "hydroxyl", 2, 1e-8), "water": ("STO-3G", "water", 0, 1e-10)}


@pytest.fixture(scope="module", params=sorted(JAX_CASES))
def jax_run(request):
    """The JAX package's UHF from its own Hückel guess, and that guess."""
    basis, mol, mult, eps = JAX_CASES[request.param]
    mpath, bpath = _paths(basis, mol)
    jsys = JaxSystem.load(mpath, JaxBasisSet.load(bpath))
    pos = jnp.asarray(jsys.positions)
    S = jax_one_electron.overlap(jsys, pos)
    H = jax_one_electron.kinetic(jsys, pos) + jax_one_electron.nuclear(jsys, pos)
    X = jax_scf.lowdin_x(S)
    nocc = jax_scf.electron_counts(jsys.n_electrons(0), mult)
    D0 = np.stack([np.asarray(jax_scf.huckel_guess(H, S, X, k, scale=1.0)) for k in nocc])
    cfg = dict(epsilon=eps, max_iterations=300, spin_multiplicity=mult)
    ref = jax_uhf(jsys, JaxConfig(**cfg), density_guess=D0)
    return request.param, jsys, D0, cfg, ref


def test_uhf_incore_matches_jax(jax_run):
    name, jsys, D0, cfg, ref = jax_run
    basis, mol = JAX_CASES[name][:2]
    out = unrestricted_hartree_fock(_system(basis, mol), HartreeFockConfig(**cfg),
                                    density_guess=D0, device="cpu")
    assert ref.converged and out.converged
    assert abs(out.total_energy() - ref.total_energy()) <= 1e-9
    assert abs(out.iterations - ref.iterations) <= 1
    np.testing.assert_allclose(out.orbital_energies_alpha, ref.orbital_energies_alpha, atol=1e-6)
    np.testing.assert_allclose(out.orbital_energies_beta, ref.orbital_energies_beta, atol=1e-6)
    assert set(out.timings) == {"one_electron_s", "eri_s", "scf_s", "total_s"}


def test_spin_expectation_matches_jax(jax_run):
    name, jsys, _, cfg, ref = jax_run
    nocc = scf.electron_counts(jsys.n_electrons(0), cfg["spin_multiplicity"])
    system = _system(*JAX_CASES[name][:2])
    out = uhf.spin_expectation(system, ref.coefficients, *nocc)
    np.testing.assert_allclose(out, jax_spin_expectation(jsys, ref.coefficients, *nocc), atol=1e-10)


# (basis, molecule, charge, multiplicity): water closed shell under the
# reference's n/2-n/2 split, and the stable water-cation doublet
MODE_CASES = {"water": ("STO-3G", "water", 0, 0), "water+": ("STO-3G", "water", 1, 2)}


@pytest.fixture(scope="module", params=sorted(MODE_CASES))
def incore_run(request):
    basis, mol, charge, mult = MODE_CASES[request.param]
    system = _system(basis, mol)
    cfg = HartreeFockConfig(epsilon=1e-10, max_iterations=300, charge=charge,
                            spin_multiplicity=mult)
    return system, cfg, unrestricted_hartree_fock(system, cfg, device="cpu")


@pytest.mark.parametrize("mode,keys", [("pair", {"eri_s", "scf_s", "total_s"}),
                                       ("direct", {"scf_s", "total_s"})])
def test_uhf_modes_agree_with_incore(incore_run, mode, keys):
    system, cfg, ref = incore_run
    out = unrestricted_hartree_fock(system, dataclasses.replace(cfg, fock_mode=mode), device="cpu")
    assert ref.converged and out.converged
    assert abs(out.total_energy() - ref.total_energy()) <= 1e-9
    assert set(out.timings) == keys


def test_uhf_sad_guess_reaches_the_fixed_point(tmp_path, monkeypatch):
    monkeypatch.setenv(CACHE_ENV, str(tmp_path))
    system = _system("6-31G", "hydroxyl")
    cfg = HartreeFockConfig(epsilon=1e-9, max_iterations=300, spin_multiplicity=2)
    huckel = unrestricted_hartree_fock(system, cfg, device="cpu")
    out = unrestricted_hartree_fock(system, dataclasses.replace(cfg, initial_guess="sad"),
                                    device="cpu")
    assert huckel.converged and out.converged
    assert abs(out.total_energy() - huckel.total_energy()) < 1e-7  # tests/test_sad.py:67
    assert "guess_s" in out.timings


@pytest.mark.parametrize("n,mult", [(9, 2), (16, 3), (10, 1), (9, 0), (10, 0), (1, 2)])
def test_electron_counts_match_jax(n, mult):
    assert scf.electron_counts(n, mult) == jax_scf.electron_counts(n, mult)


@pytest.mark.parametrize("n,mult", [(10, 2), (2, 4)])
def test_electron_counts_reject_what_jax_rejects(n, mult):
    with pytest.raises(ValueError):
        jax_scf.electron_counts(n, mult)
    with pytest.raises(ValueError):
        scf.electron_counts(n, mult)


def test_cli_uhf_prints_seven_lines(capsys):
    mpath, bpath = _paths("6-31G", "hydroxyl")
    rc = cli.main(["uhf", "-b", bpath, "-m", mpath, "--spin-multiplicity", "2", "--device", "cpu"])
    assert rc == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 7
    assert re.fullmatch(r"hartree fock converged after \d+ iterations and \d+\.\d\ds", lines[0])
    assert lines[3] == "hartree fock energy: -75.363"
    assert re.fullmatch(r"orbital energies alpha spin:   \[(-?\d+\.\d{3}, ){10}-?\d+\.\d{3}\]", lines[4])
    assert re.fullmatch(r"orbital energies beta spin: \[(-?\d+\.\d{3}, ){10}-?\d+\.\d{3}\]", lines[5])
    assert re.fullmatch(r"spin expectation <S\^2>: 0\.75\d\d \(exact 0\.7500, contamination "
                        r"\+0\.00\d\d\)", lines[6])


def test_uhf_rejects_unported_options():
    system = _system("STO-3G", "hydrogen")
    for cfg in (HartreeFockConfig(fock_mode="dense"),):  # level shift and fields are ported
        with pytest.raises(NotImplementedError):
            unrestricted_hartree_fock(system, cfg, device="cpu")
    with pytest.raises(ValueError, match="espan"):
        unrestricted_hartree_fock(system, HartreeFockConfig(convergence_metric="espan:4"),
                                  device="cpu")


def test_uhf_density_guess_shape_is_checked():
    system = _system("STO-3G", "hydrogen")
    with pytest.raises(ValueError, match="shape"):
        unrestricted_hartree_fock(system, density_guess=np.zeros((2, 2)), device="cpu")


def test_uhf_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the test covers the machine without it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        unrestricted_hartree_fock(_system("STO-3G", "hydrogen"), HartreeFockConfig())
