"""Port parity, FCI: the port's host copy of the determinant Hamiltonian
and its torch MO transform against the JAX package's on seeded inputs
(1e-12 relative), and ``fci`` end to end on H2/6-31G, water/STO-3G (RHF
and Löwdin orbitals) and the OH doublet/STO-3G against the JAX package's
``fci``: total energies within 1e-10 Eh."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qchem_rs_tpu import HartreeFockConfig as JaxConfig
from qchem_rs_tpu.models import fci as jax_fci
from qchem_rs_tpu.utils.basis import BasisSet as JaxBasisSet
from qchem_rs_tpu.utils.system import MolecularSystem as JaxSystem
from qchem_rs_tpu_torch import BasisSet, HartreeFockConfig, MolecularSystem
from qchem_rs_tpu_torch.models import fci
from tests.torch_threads import one_torch_thread  # noqa: F401

DATA = os.path.join(os.path.dirname(__file__), "..", "data")
STEP_RTOL = 1e-12
ENERGY_TOL = 1e-10  # Eh


def _systems(mol, basis):
    mpath = os.path.join(DATA, "mol", f"{mol}.json")
    bpath = os.path.join(DATA, "basis", f"{basis}.json")
    return (MolecularSystem.load(mpath, BasisSet.load(bpath)),
            JaxSystem.load(mpath, JaxBasisSet.load(bpath)))


def _seeded_integrals(n, seed):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((n, n))
    h = h + h.T
    g = rng.standard_normal((n,) * 4)
    g = g + g.transpose(1, 0, 2, 3)
    g = g + g.transpose(0, 1, 3, 2)
    g = 0.1 * (g + g.transpose(2, 3, 0, 1))
    return h, g


@pytest.mark.parametrize("n,na,nb", [(4, 2, 2), (5, 3, 2), (5, 2, 1)])
def test_build_hamiltonian_matches_jax(n, na, nb):
    h, g = _seeded_integrals(n, n * 10 + na)
    ref, dim_ref = jax_fci._build_hamiltonian(h, g, na, nb)
    H, dim = fci._build_hamiltonian(h, g, na, nb)
    assert dim == dim_ref and np.array_equal(H, ref)
    assert np.allclose(H, H.T, rtol=0, atol=1e-13)  # symmetry is emergent, not imposed


def test_fci_from_integrals_matches_jax():
    h, g = _seeded_integrals(5, 3)
    ref, _ = jax_fci.fci_from_integrals(h, g, 2, 2, 1.5, nroots=3)
    out, dim = fci.fci_from_integrals(h, g, 2, 2, 1.5, nroots=3)
    assert dim == 100 and np.max(np.abs(out - ref)) <= STEP_RTOL * np.max(np.abs(ref))
    with pytest.raises(ValueError, match="exceeds max_dim"):
        fci.fci_from_integrals(h, g, 2, 2, max_dim=50)


def test_transform_full_matches_jax():
    rng = np.random.default_rng(9)
    _, e4 = _seeded_integrals(6, 1)
    C = rng.standard_normal((6, 6))
    ref = np.asarray(jax_fci._transform_full(jnp.asarray(e4), jnp.asarray(C)))
    out = fci._transform_full(torch.as_tensor(e4), torch.as_tensor(C)).numpy()
    assert np.max(np.abs(out - ref)) <= STEP_RTOL * np.max(np.abs(ref))


# (molecule, basis, spin multiplicity, orbitals)
CASES = {"H2 6-31G": ("hydrogen", "6-31G", 0, "auto"),
         "water STO-3G rhf": ("water", "STO-3G", 1, "rhf"),
         "water STO-3G lowdin": ("water", "STO-3G", 1, "lowdin"),
         "OH doublet STO-3G": ("hydroxyl", "STO-3G", 2, "auto")}


@pytest.mark.parametrize("case", sorted(CASES))
def test_fci_matches_jax(case):
    mol, basis, mult, orbitals = CASES[case]
    port, jsys = _systems(mol, basis)
    cfg = dict(epsilon=1e-10, max_iterations=200, spin_multiplicity=mult)
    res = fci.fci(port, HartreeFockConfig(**cfg), nroots=2, orbitals=orbitals, device="cpu")
    ref = jax_fci.fci(jsys, JaxConfig(**cfg), nroots=2, orbitals=orbitals)
    assert (res.dimension, res.n_alpha, res.n_beta) == (ref.dimension, ref.n_alpha, ref.n_beta)
    assert np.max(np.abs(res.total_energies - ref.total_energies)) <= ENERGY_TOL
    assert (res.scf_total_energy is None) == (ref.scf_total_energy is None)
    if res.scf_total_energy is not None:
        assert abs(res.scf_total_energy - ref.scf_total_energy) <= 1e-9
        assert res.correlation_energy() < 0.0


def test_fci_is_orbital_invariant_and_guards():
    port, _ = _systems("water", "STO-3G")
    cfg = HartreeFockConfig(epsilon=1e-10, max_iterations=200)
    rhf = fci.fci(port, cfg, orbitals="rhf", device="cpu").total_energy()
    lowdin = fci.fci(port, cfg, orbitals="lowdin", device="cpu").total_energy()
    assert abs(rhf - lowdin) <= 1e-10
    with pytest.raises(ValueError, match="unknown orbitals"):
        fci.fci(port, cfg, orbitals="bogus", device="cpu")
    oh, _ = _systems("hydroxyl", "STO-3G")
    with pytest.raises(ValueError, match="closed shell"):
        fci.fci(oh, HartreeFockConfig(spin_multiplicity=2), orbitals="rhf", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fci.fci(port, cfg)
