"""Port parity, CIS/TDHF/UCIS: the port's block Davidson against the JAX
package's on a seeded symmetric matrix (1e-12 relative), and ``cis``/``ucis``
end to end on water/STO-3G and the OH doublet/STO-3G against the JAX
package's on the same converged orbitals (the port's SCF output, passed to
both as ``output=``): dense excitation energies within 1e-8 Eh, Davidson
roots within the solver's tol (1e-7), oscillator strengths within 1e-8."""

import os

import numpy as np
import pytest
import torch

from qchem_rs_tpu import HartreeFockConfig as JaxConfig
from qchem_rs_tpu.models import cis as jax_cis
from qchem_rs_tpu.utils.basis import BasisSet as JaxBasisSet
from qchem_rs_tpu.utils.system import MolecularSystem as JaxSystem
from qchem_rs_tpu_torch import (BasisSet, HartreeFockConfig, MolecularSystem,
                                restricted_hartree_fock, unrestricted_hartree_fock)
from qchem_rs_tpu_torch.models import cis
from tests.torch_threads import one_torch_thread  # noqa: F401

DATA = os.path.join(os.path.dirname(__file__), "..", "data")
DENSE_TOL = 1e-8  # Eh, dense excitation energies; also the oscillator strengths
DAVIDSON_TOL = 1e-7  # the solver's residual tolerance
STEP_RTOL = 1e-12


def _systems(mol, basis):
    mpath = os.path.join(DATA, "mol", f"{mol}.json")
    bpath = os.path.join(DATA, "basis", f"{basis}.json")
    return (MolecularSystem.load(mpath, BasisSet.load(bpath)),
            JaxSystem.load(mpath, JaxBasisSet.load(bpath)))


def test_davidson_sym_matches_jax():
    """A seeded diagonally dominant symmetric matrix: both solvers find the
    same lowest four eigenvalues, and those of numpy's dense eigh."""
    rng = np.random.default_rng(21)
    n = 120
    A = np.diag(np.linspace(0.5, 6.0, n)) + 0.05 * rng.standard_normal((n, n))
    A = 0.5 * (A + A.T)
    d = np.diag(A).copy()
    w_ref, _, ok_ref = jax_cis._davidson_sym_lowest(lambda X: np.asarray(X) @ A, d, 4, tol=1e-10)
    At = torch.as_tensor(A)
    w, X, ok = cis._davidson_sym_lowest(lambda X: X @ At, torch.as_tensor(d), 4, tol=1e-10)
    exact = np.linalg.eigvalsh(A)[:4]
    assert ok and ok_ref
    assert np.max(np.abs(w - w_ref)) <= STEP_RTOL * np.max(np.abs(w_ref))
    assert np.max(np.abs(w - exact)) <= 1e-10
    assert torch.linalg.norm(At @ X - X * torch.as_tensor(w)) <= 1e-9


CFG = dict(epsilon=1e-10, max_iterations=100)  # the JAX CLI's and tests' SCF


@pytest.fixture(scope="module")
def water():
    """The port's RHF, and the JAX package's in-core ``cis`` on it, one run
    per (triplet, tdhf, solver) shared by the in-core and pair cases."""
    port, jsys = _systems("water", "STO-3G")
    out = restricted_hartree_fock(port, HartreeFockConfig(**CFG), device="cpu")
    refs = {}

    def ref(triplet, tdhf, solver):
        if (triplet, tdhf, solver) not in refs:
            refs[triplet, tdhf, solver] = jax_cis.cis(jsys, JaxConfig(**CFG), nstates=4,
                                                      triplet=triplet, tdhf=tdhf, solver=solver,
                                                      output=out)
        return refs[triplet, tdhf, solver]

    return port, ref, out


# (triplet, tdhf, solver, fock mode)
CIS_CASES = {"cis singlet": (False, False, "dense", "incore"),
             "cis triplet": (True, False, "dense", "incore"),
             "tdhf singlet": (False, True, "dense", "incore"),
             "tdhf triplet": (True, True, "dense", "incore"),
             "cis singlet pair": (False, False, "dense", "pair"),
             "cis singlet davidson": (False, False, "davidson", "incore"),
             "cis triplet davidson pair": (True, False, "davidson", "pair"),
             "cis singlet davidson pair": (False, False, "davidson", "pair")}


@pytest.mark.parametrize("case", sorted(CIS_CASES))
def test_cis_matches_jax(water, case):
    port, jax_ref, out = water
    triplet, tdhf, solver, mode = CIS_CASES[case]
    res = cis.cis(port, HartreeFockConfig(**CFG, fock_mode=mode), nstates=4, triplet=triplet,
                  tdhf=tdhf, solver=solver, output=out, device="cpu")
    ref = jax_ref(triplet, tdhf, solver)
    tol = DAVIDSON_TOL if solver == "davidson" else DENSE_TOL
    assert res.method == ref.method and res.triplet == triplet
    assert np.max(np.abs(res.excitation_energies - ref.excitation_energies)) <= tol
    assert np.max(np.abs(res.oscillator_strengths - ref.oscillator_strengths)) <= tol
    assert res.iterations == out.iterations and res.scf_total_energy == out.total_energy()


@pytest.fixture(scope="module")
def hydroxyl():
    """The port's UHF on the OH doublet, and the JAX package's in-core
    ``ucis`` on it, one run per solver shared by the in-core and pair cases."""
    port, jsys = _systems("hydroxyl", "STO-3G")
    cfg = dict(epsilon=1e-12, max_iterations=300, spin_multiplicity=2)
    out = unrestricted_hartree_fock(port, HartreeFockConfig(**cfg), device="cpu")
    assert out.converged
    refs = {}

    def ref(solver):
        if solver not in refs:
            refs[solver] = jax_cis.ucis(jsys, JaxConfig(**cfg), nstates=4, solver=solver,
                                        output=out)
        return refs[solver]

    return port, ref, cfg, out


@pytest.mark.parametrize("solver,mode", [("dense", "incore"), ("davidson", "incore"),
                                         ("dense", "pair")])
def test_ucis_matches_jax(hydroxyl, solver, mode):
    port, jax_ref, cfg, out = hydroxyl
    res = cis.ucis(port, HartreeFockConfig(**cfg, fock_mode=mode), nstates=4, solver=solver,
                   output=out, device="cpu")
    ref = jax_ref(solver)
    tol = DAVIDSON_TOL if solver == "davidson" else DENSE_TOL
    assert res.method == "ucis"
    assert np.max(np.abs(res.excitation_energies - ref.excitation_energies)) <= tol
    assert np.max(np.abs(res.oscillator_strengths - ref.oscillator_strengths)) <= tol


def test_ucis_on_a_closed_shell_is_singlet_and_triplet_cis(water):
    port, _, _ = water
    cfg = HartreeFockConfig(**CFG)
    out_u = unrestricted_hartree_fock(port, cfg, device="cpu")
    u = cis.ucis(port, cfg, nstates=8, output=out_u, device="cpu").excitation_energies
    out = restricted_hartree_fock(port, cfg, device="cpu")
    both = np.sort(np.concatenate([cis.cis(port, cfg, nstates=8, triplet=t, output=out,
                                           device="cpu").excitation_energies for t in (0, 1)]))
    assert np.max(np.abs(u - both[:8])) <= 1e-8


def test_cis_guards(water):
    port, _, out = water
    with pytest.raises(ValueError, match="unknown solver"):
        cis.cis(port, output=out, solver="bogus", device="cpu")
    with pytest.raises(ValueError, match="TDHF is dense"):
        cis.cis(port, output=out, tdhf=True, solver="davidson", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cis.cis(port, output=out)
