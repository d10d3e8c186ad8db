"""Both hand-written CUDA kernels against their plain twins on the card,
and the port's RHF through them. These need an NVIDIA GPU with nvcc (the
kernels are built at first use) and skip elsewhere:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda -q

(``--noconftest``: tests/conftest.py sets up JAX, which a GPU host running
only the port need not have.)
"""

import os

import numpy as np
import pytest
import torch

from qchem_rs_tpu_torch import BasisSet, HartreeFockConfig, MolecularSystem, restricted_hartree_fock
from qchem_rs_tpu_torch.ops import eri_kernel, fock_matvec
from qchem_rs_tpu_torch.ops.angular import ncart
from qchem_rs_tpu_torch.ops.mcmurchie import nhermite

DATA = os.path.join(os.path.dirname(__file__), "..", "data")

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    return torch.device("cuda")


@pytest.mark.parametrize("Lb,Lk", [(0, 0), (1, 2), (2, 1), (4, 4), (4, 0)])
def test_eri_kernel_matches_twin(cuda, Lb, Lk):
    rng = np.random.default_rng(Lb * 5 + Lk)
    a, c, T1, T2 = 3, 2, 8, 16
    A, S1 = ncart(Lb), nhermite(Lb)
    host = [
        rng.standard_normal((2 * T1, a, A, S1)),
        rng.uniform(0.3, 8.0, (2 * T1, a)),
        rng.standard_normal((2 * T1, a, 3)) * 1.5,
        rng.uniform(0.3, 8.0, (2 * T2, c)),
        rng.standard_normal((2 * T2, c, 3)) * 1.5,
    ]
    dev = [torch.tensor(x, device=cuda) for x in host]
    ti, tj = np.array([0, T1, T1]), np.array([T2, 0, T2])
    before = eri_kernel.KERNEL.launches
    out = eri_kernel.bra_tiles(Lb, Lk, *dev, ti, tj, T1, T2)
    ref = eri_kernel.bra_tiles_plain(Lb, Lk, *dev, ti, tj, T1, T2)
    torch.cuda.synchronize()
    assert eri_kernel.KERNEL.launches == before + 1
    assert float((out - ref).abs().max() / ref.abs().max()) <= 1e-12


@pytest.mark.parametrize("m", [150, 625, 14400])
def test_fock_matvec_matches_twin(cuda, m):
    gen = torch.Generator(device=cuda).manual_seed(m)
    T = torch.randn((m, m), generator=gen, dtype=torch.float64, device=cuda)
    T = T + T.T
    d = torch.randn(m, generator=gen, dtype=torch.float64, device=cuda)
    before = fock_matvec.KERNEL.launches
    out = fock_matvec.matvec(T, d)
    torch.cuda.synchronize()
    assert fock_matvec.KERNEL.launches == before + 1
    ref = T @ d
    assert float((out - ref).abs().max() / ref.abs().max()) <= 1e-12


def test_rhf_water_ccpvdz_on_card(cuda):
    system = MolecularSystem.load(
        os.path.join(DATA, "mol", "water.json"),
        BasisSet.load(os.path.join(DATA, "basis", "cc-pVDZ.json")),
    )
    launches = eri_kernel.KERNEL.launches, fock_matvec.KERNEL.launches
    out = restricted_hartree_fock(system, HartreeFockConfig(epsilon=1e-10), device=cuda)
    assert out.converged
    assert abs(out.total_energy() - -76.02713907) <= 1e-8
    assert eri_kernel.KERNEL.launches > launches[0]
    assert fock_matvec.KERNEL.launches > launches[1]
