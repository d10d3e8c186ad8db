"""The hand-written CUDA kernels against their plain twins on the card
(kernel 3, the direct pass's tile values, for all 25 (Lb, Lk) <= (4, 4),
and its high-L part for the 24 class pairs with a side of 5 or 6),
the port's RHF through them, bitwise repeats (kernel 2, the direct build's
J and K, whole RHF runs in each Fock mode, and CCSD(T)), MP2 and CCSD(T)
on the card against the port on the CPU, a closed-shell CCSD step and
(T) on seeded inputs on the card against the CPU, and the RHF nuclear
gradient on the card against the CPU and repeated in equal bits, the
sharded builders as rank views and the conformer sweeps on the card
against the CPU. These need an NVIDIA GPU with nvcc (the
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


@pytest.mark.parametrize("Lb,Lk", [(0, 0), (1, 0), (1, 1), (2, 2), (3, 1), (0, 4), (4, 4)])
def test_eri_kernel_ragged_counts_match_twin(cuda, Lb, Lk):
    # zero-E primitive pairs interleaved before compaction, counts 1..a,
    # one bra pair all zero: the kernel sums only real primitive pairs and
    # writes zeros for ket primitive pairs past a pair's count
    rng = np.random.default_rng(100 + Lb * 5 + Lk)
    a, c, T = [9, 4, 3, 2, 1][Lb], [9, 4, 3, 2, 1][Lk], 32
    A = max(ncart(Lb - lb) * ncart(lb) for lb in range(Lb // 2 + 1))
    E1 = rng.standard_normal((2 * T, a, A, nhermite(Lb)))
    E2 = rng.standard_normal((2 * T, c, 1, 1))
    for E, n in ((E1, a), (E2, c)):
        for i in range(2 * T):
            E[i, rng.permutation(n)[: n - rng.integers(1, n + 1)]] = 0.0
    E1[-1] = 0.0
    bra = eri_kernel.compact_prims(*(torch.tensor(x, device=cuda) for x in (
        E1, rng.uniform(0.3, 8.0, (2 * T, a)), rng.standard_normal((2 * T, a, 3)) * 1.5)))
    E2, p2, P2 = eri_kernel.compact_prims(*(torch.tensor(x, device=cuda) for x in (
        E2, rng.uniform(0.3, 8.0, (2 * T, c)), rng.standard_normal((2 * T, c, 3)) * 1.5)))
    counts = eri_kernel.prim_counts(bra[0], T), eri_kernel.prim_counts(E2, T)
    ti, tj = np.array([0, T, T]), np.array([T, 0, T])
    before = eri_kernel.KERNEL.launches
    out = eri_kernel.bra_tiles(Lb, Lk, *bra, p2, P2, ti, tj, T, T, *counts)
    ref = eri_kernel.bra_tiles_plain(Lb, Lk, *bra, p2, P2, ti, tj, T, T, *counts)
    torch.cuda.synchronize()
    assert eri_kernel.KERNEL.launches == before + 1
    assert float((out - ref).abs().max() / ref.abs().max()) <= 1e-12


#: the class pairs of kernel 1's high-L part: Lb or Lk of 5 or 6
HIGHL_CLASSES = [(lb, lk) for lb in range(7) for lk in range(7) if max(lb, lk) > 4]


def _ragged_classes(rng, Lb, Lk, a, c, T, device):
    """Bra and ket classes of two tile blocks each with zero-E primitive
    pairs interleaved (counts 1..a, one bra pair all zero), compacted and
    counted as the engine does."""
    A = max(ncart(Lb - lb) * ncart(lb) for lb in range(Lb // 2 + 1))
    E1 = rng.standard_normal((2 * T, a, A, nhermite(Lb)))
    E2 = rng.standard_normal((2 * T, c, 1, 1))
    for E, n in ((E1, a), (E2, c)):
        for i in range(2 * T):
            E[i, rng.permutation(n)[: n - rng.integers(1, n + 1)]] = 0.0
    E1[-1] = 0.0
    bra = eri_kernel.compact_prims(*(torch.tensor(x, device=device) for x in (
        E1, rng.uniform(0.3, 8.0, (2 * T, a)), rng.standard_normal((2 * T, a, 3)) * 1.5)))
    E2, p2, P2 = eri_kernel.compact_prims(*(torch.tensor(x, device=device) for x in (
        E2, rng.uniform(0.3, 8.0, (2 * T, c)), rng.standard_normal((2 * T, c, 3)) * 1.5)))
    counts = eri_kernel.prim_counts(bra[0], T), eri_kernel.prim_counts(E2, T)
    return (*bra, p2, P2), counts


@pytest.mark.parametrize("Lb,Lk", HIGHL_CLASSES)
def test_highl_kernel_ragged_counts_match_twin(cuda, Lb, Lk):
    # the f-shell pair classes go to the high-L part, which holds the same
    # count contract as the template part
    rng = np.random.default_rng(300 + Lb * 7 + Lk)
    prims = [3, 3, 2, 2, 1, 2, 1]
    args, counts = _ragged_classes(rng, Lb, Lk, prims[Lb], prims[Lk], 8, cuda)
    ti, tj = np.array([0, 8, 8]), np.array([8, 0, 8])
    before = eri_kernel.HIGHL_KERNEL.launches, eri_kernel.KERNEL.launches
    out = eri_kernel.bra_tiles(Lb, Lk, *args, ti, tj, 8, 8, *counts)
    ref = eri_kernel.bra_tiles_plain(Lb, Lk, *args, ti, tj, 8, 8, *counts)
    torch.cuda.synchronize()
    assert (eri_kernel.HIGHL_KERNEL.launches, eri_kernel.KERNEL.launches) == (before[0] + 1, before[1])
    assert float((out - ref).abs().max() / ref.abs().max()) <= 1e-12


def test_cuda_dispatch_serves_every_class_up_to_f_pairs(cuda):
    # no class pair up to (6, 6) raises on CUDA: Lb, Lk <= 4 take the
    # template part, the rest the high-L part; nothing falls back to the twin
    rng = np.random.default_rng(11)
    for Lb in range(eri_kernel.HIGHL_MAX_SIDE + 1):
        for Lk in range(eri_kernel.HIGHL_MAX_SIDE + 1):
            args, counts = _ragged_classes(rng, Lb, Lk, 1, 1, 4, cuda)
            part = eri_kernel.KERNEL if max(Lb, Lk) <= 4 else eri_kernel.HIGHL_KERNEL
            before = part.launches
            out = eri_kernel.bra_tiles(Lb, Lk, *args, np.array([0]), np.array([4]), 4, 4, *counts)
            torch.cuda.synchronize()
            assert part.launches == before + 1
            assert bool(torch.isfinite(out).all())
    with pytest.raises(ValueError, match="Lb, Lk <= 6"):
        args, counts = _ragged_classes(rng, 7, 0, 1, 1, 4, cuda)
        eri_kernel.bra_tiles(7, 0, *args, np.array([0]), np.array([0]), 4, 4, *counts)


#: every class pair of kernel 3: Lb, Lk <= 4
VALUES_CLASSES = [(lb, lk) for lb in range(5) for lk in range(5)]


def _ragged_values_classes(rng, Lb, Lk, a, c, T1, T2, device, which=0, zero_rows=1):
    """Bra and ket classes of two tile blocks each, E of both sides whole
    (N, n, A, S), zero-E primitive pairs interleaved (counts 1..n, the last
    ``zero_rows`` bra pairs all zero), compacted and counted as the engine
    does; A and C the ``which``-th component counts of the pair classes."""
    comps = [[ncart(L - lb) * ncart(lb) for lb in range(L // 2 + 1)] for L in (Lb, Lk)]
    A, C = (x[which % len(x)] for x in comps)
    sides = []
    for L, n, T, X, zero in ((Lb, a, T1, A, zero_rows), (Lk, c, T2, C, 0)):
        N = 2 * T
        E = rng.standard_normal((N, n, X, nhermite(L)))
        for i in range(N):
            E[i, rng.permutation(n)[: n - rng.integers(1, n + 1)]] = 0.0
        E[N - zero:] = 0.0
        side = eri_kernel.compact_prims(*(torch.tensor(x, device=device) for x in (
            E, rng.uniform(0.3, 8.0, (N, n)), rng.standard_normal((N, n, 3)) * 1.5)))
        sides.append((side, eri_kernel.prim_counts(side[0], T)))
    ((E1, p1, P1), bra), ((E2, p2, P2), ket) = sides
    return (E1, p1, P1, E2, p2, P2), bra, ket


@pytest.mark.parametrize("Lb,Lk", VALUES_CLASSES)
def test_tile_values_kernel_ragged_counts_match_twin(cuda, Lb, Lk):
    # kernel 3 against ket_contract(bra_tiles_plain(...)) with ragged counts,
    # at the largest tile edge (32) and with ket tiles of one pair and a
    # third of the bra rows without a real primitive pair
    rng = np.random.default_rng(500 + Lb * 5 + Lk)
    prims = [9, 4, 3, 2, 1]
    for which, (T1, T2, zero_rows) in enumerate(((32, 32, 1), (16, 1, 11))):
        args, bra, ket = _ragged_values_classes(rng, Lb, Lk, prims[Lb], prims[Lk], T1, T2, cuda,
                                                which, zero_rows)
        ti, tj = np.array([0, T1, T1, 0]), np.array([T2, 0, T2, 0])
        before = eri_kernel.VALUES_KERNEL.launches
        out = eri_kernel.tile_values(Lb, Lk, *args, ti, tj, T1, T2, bra, ket)
        ref = eri_kernel.tile_values_plain(Lb, Lk, *args, ti, tj, T1, T2, bra, ket)
        torch.cuda.synchronize()
        assert eri_kernel.VALUES_KERNEL.launches == before + 1
        assert out.shape == ref.shape == (4, T1 * args[0].shape[2], T2 * args[3].shape[2])
        assert float((out - ref).abs().max() / ref.abs().max()) <= 1e-12


@pytest.mark.parametrize("Lb,Lk", [(0, 0), (1, 1), (2, 3), (4, 4)])
def test_tile_values_kernel_twice_is_bitwise_equal(cuda, Lb, Lk):
    # a fixed summation order: no atomics
    rng = np.random.default_rng(600 + Lb * 5 + Lk)
    args, bra, ket = _ragged_values_classes(rng, Lb, Lk, 3, 3, 32, 32, cuda)
    ti, tj = np.array([0, 32, 32]), np.array([32, 0, 32])
    out = eri_kernel.tile_values(Lb, Lk, *args, ti, tj, 32, 32, bra, ket)
    assert torch.equal(out, eri_kernel.tile_values(Lb, Lk, *args, ti, tj, 32, 32, bra, ket))


#: every class pair of kernel 3's high-L part: a side of 5 or 6
VALUES_HIGHL_CLASSES = [(lb, lk) for lb in range(7) for lk in range(7) if max(lb, lk) > 4]


@pytest.mark.parametrize("Lb,Lk", VALUES_HIGHL_CLASSES)
def test_tile_values_highl_ragged_counts_match_twin(cuda, Lb, Lk):
    # kernel 3's high-L part against its twin with ragged counts, at the
    # largest tile edge and with ket tiles of one pair and a third of the
    # bra rows without a real primitive pair, from both sides; relaunched,
    # the same bits (a fixed summation order, no atomics)
    rng = np.random.default_rng(700 + Lb * 7 + Lk)
    prims = [9, 4, 3, 2, 1, 2, 1]
    for which, (T1, T2, zero_rows) in enumerate(((32, 32, 1), (16, 1, 11))):
        args, bra, ket = _ragged_values_classes(rng, Lb, Lk, prims[Lb], prims[Lk], T1, T2, cuda,
                                                which, zero_rows)
        ti, tj = np.array([0, T1, T1, 0]), np.array([T2, 0, T2, 0])
        ref = eri_kernel.tile_values_plain(Lb, Lk, *args, ti, tj, T1, T2, bra, ket)
        for trans in (False, True):
            before = eri_kernel.VALUES_HIGHL_KERNEL.launches
            out = eri_kernel.tile_values(Lb, Lk, *args, ti, tj, T1, T2, bra, ket, trans=trans)
            again = eri_kernel.tile_values(Lb, Lk, *args, ti, tj, T1, T2, bra, ket, trans=trans)
            torch.cuda.synchronize()
            assert eri_kernel.VALUES_HIGHL_KERNEL.launches == before + 2
            assert float((out - ref).abs().max() / ref.abs().max()) <= 1e-12
            assert torch.equal(out, again)


def test_kernel_boys_matches_boys(cuda):
    from qchem_rs_tpu_torch.ops.boys import boys

    T = torch.linspace(0.0, 50.0, 20001, dtype=torch.float64, device=cuda)
    for M in range(eri_kernel.KERNEL_MAX_L + 1):
        ref = boys(M, T)
        assert float(((eri_kernel.boys_on_card(M, T) - ref).abs() / ref.abs()).max()) <= 1e-14


@pytest.mark.parametrize("m", [64, 65, 150, 625, 14400, 14401])
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


def _water_ccpvdz():
    return MolecularSystem.load(
        os.path.join(DATA, "mol", "water.json"),
        BasisSet.load(os.path.join(DATA, "basis", "cc-pVDZ.json")),
    )


def _density_stack(nd, n, seed):
    D = np.random.default_rng(seed).standard_normal((nd, n, n))
    return torch.tensor(D + D.transpose(0, 2, 1))


def test_pair_j_through_kernel2_matches_twin(cuda):
    from qchem_rs_tpu_torch.ops.fock_pair import PairSpaceFockBuilder

    system = _water_ccpvdz()
    D = _density_stack(1, system.n_basis(), 1)[0]
    builder = PairSpaceFockBuilder(system, 1e-12, device=cuda)
    V2f, _ = builder.prepare()
    before = fock_matvec.KERNEL.launches
    J, K = builder.jk(D.to(cuda))
    torch.cuda.synchronize()
    assert fock_matvec.KERNEL.launches == before + 1
    dJ, _ = builder.density_vectors(D.to(cuda))
    out, ref = fock_matvec.matvec(V2f, dJ), fock_matvec.matvec_plain(V2f, dJ)
    assert float((out - ref).abs().max() / ref.abs().max()) <= 1e-12
    J_cpu, K_cpu = PairSpaceFockBuilder(system, 1e-12, device="cpu").jk(D)
    scale = max(float(J_cpu.abs().max()), 1.0)
    assert float((J.cpu() - J_cpu).abs().max()) / scale <= 1e-11
    assert float((K.cpu() - K_cpu).abs().max()) / scale <= 1e-11


def test_direct_jk_on_card_matches_cpu_twin(cuda):
    from qchem_rs_tpu_torch.ops.fock_stream import StreamingFockBuilder

    system = _water_ccpvdz()
    D = _density_stack(2, system.n_basis(), 2)
    builder = StreamingFockBuilder(system, 1e-12, device=cuda)
    before = eri_kernel.VALUES_KERNEL.launches, eri_kernel.KERNEL.launches
    J, K = builder.jk_stack_cart(D.to(cuda))
    torch.cuda.synchronize()
    # water/cc-pVDZ has no f shell: every batch goes through kernel 3
    assert eri_kernel.VALUES_KERNEL.launches == before[0] + len(builder.batches)
    assert eri_kernel.KERNEL.launches == before[1]
    J_cpu, K_cpu = StreamingFockBuilder(system, 1e-12, device="cpu").jk_stack_cart(D)
    scale = max(float(J_cpu.abs().max()), 1.0)
    assert float((J.cpu() - J_cpu).abs().max()) / scale <= 1e-11
    assert float((K.cpu() - K_cpu).abs().max()) / scale <= 1e-11


@pytest.mark.parametrize("m", [150, 14400, 14401])
def test_fock_matvec_twice_is_bitwise_equal(cuda, m):
    # kernel 2 adds its partial sums in a fixed order: no atomics
    gen = torch.Generator(device=cuda).manual_seed(m + 1)
    T = torch.randn((m, m), generator=gen, dtype=torch.float64, device=cuda)
    T = T + T.T
    d = torch.randn(m, generator=gen, dtype=torch.float64, device=cuda)
    assert torch.equal(fock_matvec.matvec(T, d), fock_matvec.matvec(T, d))


def test_direct_jk_twice_is_bitwise_equal(cuda):
    from qchem_rs_tpu_torch.ops.fock_stream import StreamingFockBuilder

    system = _water_ccpvdz()
    D = _density_stack(1, system.n_basis(), 3)[0].to(cuda)
    builder = StreamingFockBuilder(system, 1e-12, device=cuda)
    before = eri_kernel.VALUES_KERNEL.launches
    (J1, K1), (J2, K2) = builder.jk(D), builder.jk(D)
    assert eri_kernel.VALUES_KERNEL.launches == before + 2 * len(builder.batches)
    assert torch.equal(J1, J2) and torch.equal(K1, K2)


@pytest.mark.parametrize("mode", ["incore", "pair", "direct"])
def test_rhf_twice_on_card_is_bitwise_equal(cuda, mode):
    system = _water_ccpvdz()
    cfg = HartreeFockConfig(epsilon=1e-10, fock_mode=mode)
    o1 = restricted_hartree_fock(system, cfg, device=cuda)
    o2 = restricted_hartree_fock(system, cfg, device=cuda)
    assert o1.converged and o1.iterations == o2.iterations
    assert o1.electronic_energy == o2.electronic_energy
    assert (o1.density == o2.density).all()


@pytest.mark.parametrize("fn", ["mp2", "mp2_pair_space"])
def test_mp2_on_card_matches_cpu(cuda, fn):
    from qchem_rs_tpu_torch.models import mp2

    system = MolecularSystem.load(os.path.join(DATA, "mol", "water.json"),
                                  BasisSet.load(os.path.join(DATA, "basis", "6-31G.json")))
    out = restricted_hartree_fock(system, HartreeFockConfig(epsilon=1e-10), device="cpu")
    launches = eri_kernel.KERNEL.launches
    card = getattr(mp2, fn)(system, frozen="auto", output=out, device=cuda)
    assert eri_kernel.KERNEL.launches > launches
    cpu = getattr(mp2, fn)(system, frozen="auto", output=out, device="cpu")
    assert abs(card.correlation_energy - cpu.correlation_energy) <= 1e-10


def _spatial_step_inputs(device):
    """Seeded closed-shell CC inputs (o = 4, v = 9) on ``device``: the
    physicist blocks of a chemist-symmetric e4, amplitudes and orbital
    energies."""
    from qchem_rs_tpu_torch.models import cc

    rng = np.random.default_rng(13)
    no, nv = 4, 9
    n = no + nv
    e = rng.standard_normal((n,) * 4)
    e = e + e.transpose(1, 0, 2, 3)
    e = e + e.transpose(0, 1, 3, 2)
    e = 0.05 * (e + e.transpose(2, 3, 0, 1))
    C = np.linalg.qr(rng.standard_normal((n, n)))[0]
    T = rng.standard_normal((no, no, nv, nv)) * 0.05
    host = [rng.standard_normal((no, nv)) * 0.05, T + T.transpose(1, 0, 3, 2),
            -1.0 - rng.random(no), 0.5 + rng.random(nv)]
    t = [torch.as_tensor(x, device=device) for x in host]
    g = cc._mo_phys_blocks(torch.as_tensor(e, device=device), torch.as_tensor(C[:, :no], device=device),
                           torch.as_tensor(C[:, no:], device=device))
    return t, g


def test_ccsd_step_and_triples_on_card_match_cpu(cuda):
    from qchem_rs_tpu_torch.models import cc

    t_card, g_card = _spatial_step_inputs(cuda)
    t_cpu, g_cpu = _spatial_step_inputs("cpu")
    for a, b in zip(cc._ccsd_rhf_step(*t_card, g_card), cc._ccsd_rhf_step(*t_cpu, g_cpu)):
        assert float((a.cpu() - b).abs().max() / b.abs().max()) <= 1e-12
    card = float(cc._triples_energy_rhf_batched(*t_card, g_card))
    cpu = float(cc._triples_energy_rhf_batched(*t_cpu, g_cpu))
    assert abs(card - cpu) <= 1e-12 * abs(cpu)


def test_ccsd_t_twice_on_card_is_bitwise_equal(cuda):
    from qchem_rs_tpu_torch.models.cc import ccsd

    system = MolecularSystem.load(os.path.join(DATA, "mol", "water.json"),
                                  BasisSet.load(os.path.join(DATA, "basis", "6-31G.json")))
    out = restricted_hartree_fock(system, HartreeFockConfig(epsilon=1e-10), device=cuda)
    a = ccsd(system, triples=True, output=out, device=cuda)
    b = ccsd(system, triples=True, output=out, device=cuda)
    cpu = ccsd(system, triples=True, output=out, device="cpu")
    assert a.correlation_energy == b.correlation_energy
    assert a.triples_correction == b.triples_correction and a.iterations == b.iterations
    assert abs(a.total_energy() - cpu.total_energy()) <= 1e-10


@pytest.mark.parametrize("mode", ["incore", "pair"])
def test_rhf_gradient_on_card_matches_cpu(cuda, mode):
    """Water/6-31G: the card's analytic gradient against the port's on the
    CPU within 1e-10 Eh/Bohr, and two card runs on the same SCF output
    equal in bits."""
    from qchem_rs_tpu_torch import rhf_gradient

    system = MolecularSystem.load(os.path.join(DATA, "mol", "water.json"),
                                  BasisSet.load(os.path.join(DATA, "basis", "6-31G.json")))
    cfg = HartreeFockConfig(epsilon=1e-11, max_iterations=200, fock_mode=mode)
    out = restricted_hartree_fock(system, cfg, device=cuda)
    g = rhf_gradient(system, cfg, output=out, device=cuda)
    again = rhf_gradient(system, cfg, output=out, device=cuda)
    cpu = rhf_gradient(system, cfg, output=out, device="cpu")
    assert np.abs(g - cpu).max() <= 1e-10
    assert np.array_equal(g, again)


@pytest.mark.parametrize("kind", ["stream", "pair", "column"])
def test_sharded_rank_views_on_card_match_cpu(cuda, kind):
    """Water/cc-pVDZ (M = 428): four rank views of each sharded builder on
    the card, their shares added in rank order, against the port's
    unsharded pair-space J/K on the CPU."""
    from qchem_rs_tpu_torch.ops.eri_tiled import TiledEriEngine
    from qchem_rs_tpu_torch.ops.fock_pair import PairSpaceFockBuilder, PairSpaceShardedFockBuilder
    from qchem_rs_tpu_torch.parallel.fock_sharded import ShardedFockBuilder
    from qchem_rs_tpu_torch.parallel.mesh import rank_view
    from qchem_rs_tpu_torch.parallel.v2_sharded import (ColumnShardedPairFockBuilder,
                                                        prepare_rank_views)

    system = _water_ccpvdz()
    D = _density_stack(1, system.n_basis(), 4)[0]
    cls = {"stream": ShardedFockBuilder, "pair": PairSpaceShardedFockBuilder,
           "column": ColumnShardedPairFockBuilder}[kind]
    engine = TiledEriEngine(system, 1e-12, device=cuda)
    views = [cls(system, rank_view(4, r, cuda), 1e-12, engine=engine) for r in range(4)]
    if kind == "column":
        prepare_rank_views(views)
    J = K = 0.0
    for view in views:
        Jr, Kr = view.jk_partial(D.to(cuda))
        J, K = J + Jr.cpu(), K + Kr.cpu()
    J_cpu, K_cpu = PairSpaceFockBuilder(system, 1e-12, device="cpu").jk(D)
    scale = max(float(J_cpu.abs().max()), 1.0)
    assert float((J - J_cpu).abs().max()) / scale <= 1e-11
    assert float((K - K_cpu).abs().max()) / scale <= 1e-11


def test_conformer_sweeps_on_card_match_cpu(cuda):
    """Water/STO-3G at four scales: the conformer sweep and the in-core
    chain on the card against the CPU, and the sweep against single runs
    in equal bits."""
    from qchem_rs_tpu_torch.parallel.sweep import chained_sweep, conformer_sweep

    system = MolecularSystem.load(os.path.join(DATA, "mol", "water.json"),
                                  BasisSet.load(os.path.join(DATA, "basis", "STO-3G.json")))
    geoms = np.stack([np.asarray(system.positions) * s for s in (0.95, 1.0, 1.05, 1.1)])
    cfg = HartreeFockConfig(epsilon=1e-12)
    e, c = conformer_sweep(system, geoms, cfg, device=cuda)
    e_cpu, _ = conformer_sweep(system, geoms, cfg, device="cpu")
    chain, _ = chained_sweep(system, geoms, cfg, device=cuda)
    assert c.all() and np.abs(e - e_cpu).max() <= 1e-10 and np.abs(chain - e).max() <= 1e-10
    for g, x in zip(geoms, e):
        assert restricted_hartree_fock(system.with_positions(g), cfg, device=cuda).total_energy() == x
