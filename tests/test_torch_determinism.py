"""The port's SCF repeats bit for bit, as the JAX package's does
(tests/test_determinism.py): two RHF runs on the CPU give the same energy
and density bits in every Fock mode; the direct build reduces in a fixed
order (no ``index_add_``, whose CUDA adds land in a run-to-run order); and
kernel 2's scratch layout, which replaces its atomics, covers every slot
once. The same repeats on the card are in tests/test_torch_cuda.py."""

import os

import numpy as np
import pytest
import torch

from qchem_rs_tpu_torch import (BasisSet, HartreeFockConfig, MolecularSystem,
                                restricted_hartree_fock, unrestricted_hartree_fock)
from qchem_rs_tpu_torch.ops import fock_matvec
from qchem_rs_tpu_torch.ops.fock_stream import StreamingFockBuilder
from tests.torch_threads import one_torch_thread  # noqa: F401

DATA = os.path.join(os.path.dirname(__file__), "..", "data")


def _system(mol, basis):
    return MolecularSystem.load(os.path.join(DATA, "mol", f"{mol}.json"),
                                BasisSet.load(os.path.join(DATA, "basis", f"{basis}.json")))


@pytest.mark.parametrize("mode", ["incore", "pair", "direct"])
def test_rhf_twice_is_bitwise_equal(mode):
    system = _system("water", "STO-3G")
    cfg = HartreeFockConfig(epsilon=1e-10, fock_mode=mode)
    o1 = restricted_hartree_fock(system, cfg, device="cpu")
    o2 = restricted_hartree_fock(system, cfg, device="cpu")
    assert o1.converged and o1.iterations == o2.iterations
    assert o1.electronic_energy == o2.electronic_energy
    assert (o1.density == o2.density).all()


def test_uhf_direct_twice_is_bitwise_equal():
    system = _system("water", "STO-3G")
    cfg = HartreeFockConfig(epsilon=1e-10, fock_mode="direct", charge=1, spin_multiplicity=2)
    o1 = unrestricted_hartree_fock(system, cfg, device="cpu")
    o2 = unrestricted_hartree_fock(system, cfg, device="cpu")
    assert o1.converged and o1.iterations == o2.iterations
    assert o1.electronic_energy == o2.electronic_energy
    assert (o1.density == o2.density).all()


def test_direct_build_does_not_index_add(monkeypatch):
    # index_add_ on CUDA adds duplicate indices in no fixed order; the
    # direct build must not call it (on any device)
    def refuse(*args, **kwargs):
        raise AssertionError("index_add_ called")

    builder = StreamingFockBuilder(_system("water", "6-31G"), 1e-12, device="cpu")
    rng = np.random.default_rng(0)
    D = rng.normal(size=(2, builder.nao, builder.nao))
    D = torch.tensor(D + D.transpose(0, 2, 1))
    J0, K0 = builder.jk_stack(D)
    monkeypatch.setattr(torch.Tensor, "index_add_", refuse)
    J, K = builder.jk_stack(D)
    assert torch.equal(J, J0) and torch.equal(K, K0)


@pytest.mark.parametrize("m", [1, 63, 64, 65, 150, 200])
def test_kernel2_partials_cover_every_slot_once(m):
    # kernel 2 writes each block's row and column sums into slots of its
    # own in a (ceil(m / 64), m) scratch and adds the rows in a fixed
    # order: every slot is written (none left NaN), and the rows sum to the
    # half-read product
    rng = np.random.default_rng(m)
    T = torch.tensor(rng.normal(size=(m, m)))
    d = torch.tensor(rng.normal(size=m))
    P = fock_matvec.partials_plain(T, d)
    assert P.shape == (-(-m // fock_matvec.BLOCK), m)
    assert not torch.isnan(P).any()
    torch.testing.assert_close(P.sum(0), fock_matvec.matvec_upper_plain(T, d), rtol=0, atol=1e-12)
