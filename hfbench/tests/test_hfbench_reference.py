"""The plain reference against the port on the CPU, and its Boys function
against mpmath."""

import math

import numpy as np
import pytest
import torch

from hfbench.reference.hermite import boys
from hfbench.reference.integrals import fock_operator, one_electron, pair_matrix
from hfbench.reference.molecule import Molecule, read_basis, read_molecule
from hfbench.reference.scf import Reference
from hfbench.tests.conftest import DATA, ROOT


@pytest.mark.parametrize("mmax", [0, 4, 8, 12])
def test_boys_against_mpmath(mmax):
    mpmath = pytest.importorskip("mpmath")
    mpmath.mp.dps = 40
    T = torch.tensor([0.0, 1e-6, 1e-3, 0.3, 2.0, mmax + 1.49, mmax + 1.51, 11.0, 30.0, 120.0],
                     dtype=torch.float64)
    got = boys(mmax, T)
    for m in range(mmax + 1):
        for k, t in enumerate(T.tolist()):
            want = mpmath.quad(lambda u: u ** (2 * m) * mpmath.exp(-t * u * u), [0, 1])
            assert abs(float(got[m, k]) - float(want)) <= 1e-14 * float(want), (m, t)


def _systems(basis_name, displaced):
    from qchem_rs_tpu_torch.utils.basis import BasisSet
    from qchem_rs_tpu_torch.utils.system import MolecularSystem

    z, x = read_molecule(ROOT / "data/mol/water.json")
    if displaced:
        x = x + np.random.default_rng(5).normal(0.0, 0.08, x.shape)
    mol = Molecule(z, x, read_basis(ROOT / f"data/basis/{basis_name}.json"))
    port = MolecularSystem.load(ROOT / "data/mol/water.json",
                                BasisSet.load(ROOT / f"data/basis/{basis_name}.json")).with_positions(x)
    return mol, port


@pytest.mark.parametrize("basis_name", ["STO-3G", "cc-pVDZ"])
@pytest.mark.parametrize("displaced", [False, True])
def test_integrals_match_the_port(basis_name, displaced):
    from qchem_rs_tpu_torch.ops import one_electron as port_one
    from qchem_rs_tpu_torch.ops.eri_tiled import TiledEriEngine

    mol, port = _systems(basis_name, displaced)
    S, T, V = one_electron(mol)
    for mine, theirs in ((S, port_one.overlap), (T, port_one.kinetic), (V, port_one.nuclear)):
        assert torch.allclose(mine, theirs(port, "cpu"), rtol=0, atol=1e-12)
    eng = TiledEriEngine(port, 0.0, device="cpu")
    e4 = eng.finish_eri(eng.build()).reshape(mol.nao ** 2, mol.nao ** 2)
    G = fock_operator(pair_matrix(mol, 0.0), mol.nao)
    n = mol.nao
    K = e4.view(n, n, n, n).transpose(1, 2).reshape(n * n, n * n)
    assert torch.allclose(G, e4 - 0.5 * K, rtol=0, atol=1e-12)


@pytest.mark.parametrize("displaced", [False, True])
@pytest.mark.parametrize("fock_mode", ["incore", "direct"])
def test_rhf_matches_the_port(displaced, fock_mode):
    from qchem_rs_tpu_torch.config import HartreeFockConfig
    from qchem_rs_tpu_torch.models.rhf import restricted_hartree_fock

    mol, port = _systems("STO-3G", displaced)
    ref = Reference(mol, 1e-12)
    sol = ref.solve()
    assert sol.converged
    out = restricted_hartree_fock(port, HartreeFockConfig(epsilon=1e-10, initial_guess="sad", fock_mode=fock_mode),
                                  device="cpu")
    assert out.converged
    gaps = ref.judge(sol, out.total_energy(), out.orbital_energies, out.density)
    assert gaps["energy_gap"] < 1e-9 and gaps["orbital_gap"] < 1e-7 and gaps["commutator"] < 1e-7, gaps
    assert math.isclose(sol.energy, -74.96, abs_tol=0.01) or displaced


def test_test_data_are_copies():
    for name, origin in (("water.json", "data/mol/water.json"), ("STO-3G.json", "data/basis/STO-3G.json")):
        assert (DATA / name).read_bytes() == (ROOT / origin).read_bytes()
    for name, origin in (("naphthalene.json", "data/mol/naphthalene.json"),
                         ("cc-pVDZ.json", "data/basis/cc-pVDZ.json")):
        assert (ROOT / "hfbench/data" / name).read_bytes() == (ROOT / origin).read_bytes()
