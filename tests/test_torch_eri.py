"""Port parity, ERI layer: kernel 1's plain twin against the JAX tile twin
``eri_tiled._tile_vals``, the pair groups, Schwarz bounds and the RHF
operator ``finish_terms`` against the JAX package on the CPU.

The JAX Pallas ERI kernels do not run on the CPU (interpret mode hits the
compile pathology described in tests/test_eri_pallas.py), so their plain
reference ``_tile_vals`` is what the port's twin is held against. Kernel 1
itself runs only on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from qchem_rs_tpu.ops.eri_tiled import TiledEriEngine as JaxEngine
from qchem_rs_tpu.ops.fock_pair import PairSpaceFockBuilder as JaxPairBuilder
from qchem_rs_tpu.ops.eri_tiled import _tile_vals as _jax_tile_vals_eager
from qchem_rs_tpu.utils.basis import BasisSet as JaxBasisSet
from qchem_rs_tpu.utils.system import MolecularSystem as JaxSystem
from qchem_rs_tpu_torch.ops import eri_kernel, eri_tiled, fock_matvec
from qchem_rs_tpu_torch.ops.angular import ncart
from qchem_rs_tpu_torch.ops.eri_kernel import ket_contract
from qchem_rs_tpu_torch.ops.eri_tiled import (
    TiledEriEngine,
    _tile_vals,
    mirror_inplace,
    pad_group,
)
from qchem_rs_tpu_torch.ops.mcmurchie import nhermite
from qchem_rs_tpu_torch.utils.basis import BasisSet
from qchem_rs_tpu_torch.utils.interop import pair_group_from_numpy, to_tensor
from qchem_rs_tpu_torch.utils.system import MolecularSystem
from tests.torch_threads import one_torch_thread  # noqa: F401

DATA = os.path.join(os.path.dirname(__file__), "..", "data")

#: the JAX tile twin as one compiled program (eager dispatch of its op
#: chain costs seconds per shape)
jax_tile_vals = jax.jit(_jax_tile_vals_eager, static_argnums=(0, 1))


def _random_tile(Lb, Lk, a, c, T1, T2, seed):
    rng = np.random.default_rng(seed)
    A, C = ncart(Lb), ncart(Lk)
    return (
        rng.standard_normal((T1, a, A, nhermite(Lb))),
        rng.uniform(0.3, 8.0, (T1, a)),
        rng.standard_normal((T1, a, 3)) * 1.5,
        rng.standard_normal((T2, c, C, nhermite(Lk))),
        rng.uniform(0.3, 8.0, (T2, c)),
        rng.standard_normal((T2, c, 3)) * 1.5,
    )


@pytest.mark.parametrize(
    "Lb,Lk,a,c,T1,T2",
    [
        (0, 0, 9, 9, 16, 32),
        (1, 1, 4, 4, 8, 16),
        (2, 2, 2, 2, 8, 8),
        (4, 4, 1, 1, 8, 8),
        (1, 2, 4, 2, 8, 8),
        (4, 0, 1, 9, 8, 16),
        # f-shell pair classes (Lb or Lk of 5 or 6), the high-L part's
        (5, 0, 1, 6, 4, 8),
        (5, 3, 1, 2, 4, 4),
        (6, 2, 1, 2, 4, 4),
        (3, 6, 2, 1, 4, 4),
        (6, 6, 1, 1, 2, 2),
    ],
)
def test_tile_twin_matches_jax_tile_vals(Lb, Lk, a, c, T1, T2):
    host = _random_tile(Lb, Lk, a, c, T1, T2, seed=Lb * 5 + Lk)
    ref = np.asarray(jax_tile_vals(Lb, Lk, *(jnp.asarray(x) for x in host)))
    out = _tile_vals(Lb, Lk, *(to_tensor(x, "cpu") for x in host)).numpy()
    assert out.shape == ref.shape
    assert np.max(np.abs(out - ref)) / np.max(np.abs(ref)) <= 1e-12


def test_bra_tiles_cpu_takes_twin_and_checks_inputs():
    E1, p1, P1, _, p2, P2 = (to_tensor(x, "cpu") for x in _random_tile(1, 2, 4, 2, 8, 4, seed=3))
    E1 = torch.cat([E1, E1])  # two bra tiles' worth of pairs
    p1, P1 = torch.cat([p1, p1]), torch.cat([P1, P1])
    ti, tj = np.array([0, 8]), np.array([0, 0])
    before = eri_kernel.KERNEL.launches
    out = eri_kernel.bra_tiles(1, 2, E1, p1, P1, p2, P2, ti, tj, 8, 4)
    ref = eri_kernel.bra_tiles_plain(1, 2, E1, p1, P1, p2, P2, ti, tj, 8, 4)
    assert out.shape == (2, ncart(1), 2 * nhermite(2), 8, 4)
    assert torch.equal(out, ref)
    assert eri_kernel.KERNEL.launches == before  # CPU tensors never launch
    with pytest.raises(ValueError, match="outside"):
        eri_kernel.bra_tiles(1, 2, E1, p1, P1, p2, P2, np.array([9]), np.array([0]), 8, 4)
    with pytest.raises(TypeError, match="float64"):
        eri_kernel.bra_tiles(1, 2, E1.float(), p1, P1, p2, P2, ti, tj, 8, 4)
    with pytest.raises(ValueError, match="Lb=2"):
        eri_kernel.bra_tiles(2, 2, E1, p1, P1, p2, P2, ti, tj, 8, 4)


@pytest.mark.parametrize("block", [1, 5, 8, 36, 37, 64])
def test_mirror_inplace_fills_lower_triangle(block):
    # blocks that divide the matrix, leave a ragged edge, or exceed it
    rng = np.random.default_rng(5)
    full = rng.standard_normal((37, 37))
    full = full + full.T
    V2 = torch.tensor(np.triu(full))
    out = mirror_inplace(V2, block=block)
    assert out is V2
    np.testing.assert_array_equal(out.numpy(), full)


def _meta(npairs, tile):
    npad = tile * -(-npairs // tile)
    return eri_tiled._ClassMeta(la=0, lb=0, A=1, npairs=npairs, npad=npad, tile=tile,
                                row_base=0, a=1)


@pytest.mark.parametrize("same", [False, True])
@pytest.mark.parametrize("threshold", [None, 1e-6, 1e-2, 0.5])
def test_tile_list_matches_pairwise_screening(threshold, same):
    # a tile is kept when some real pair of its rows and some of its
    # columns have a Schwarz product above the threshold; in a diagonal
    # class block, tiles wholly below the diagonal are left to the mirror
    rng = np.random.default_rng(7)
    m1 = _meta(29, 8)
    m2 = m1 if same else _meta(21, 4)
    b1 = 10.0 ** rng.uniform(-9, 0, m1.npairs)
    b2 = b1 if same else 10.0 ** rng.uniform(-9, 0, m2.npairs)
    bounds = (None, None) if threshold is None else (b1, b2)
    ti, tj, tb = eri_tiled._tile_list(m1, m2, m1.tile, m2.tile, *bounds, threshold, same)
    want = []
    for i in range(0, m1.npairs, m1.tile):
        for j in range(0, m2.npairs, m2.tile):
            if same and j + m2.tile <= i:
                continue
            top = max(b1[p] * b2[q] for p in range(i, min(i + m1.tile, m1.npairs))
                      for q in range(j, min(j + m2.tile, m2.npairs)))
            if threshold is None:
                want.append((i, j, 1.0))
            elif top > threshold:
                want.append((i, j, top))
    assert [(int(a), int(b)) for a, b in zip(ti, tj)] == [(i, j) for i, j, _ in want]
    np.testing.assert_allclose(tb, [b for _, _, b in want], rtol=1e-15, atol=0)


@pytest.fixture(scope="module")
def water_631gs_port():
    """The port's tiled engine on water/6-31G* (d shells), screened at
    1e-12 as the RHF default."""
    port_sys = MolecularSystem.load(
        os.path.join(DATA, "mol", "water.json"),
        BasisSet.load(os.path.join(DATA, "basis", "6-31G_st.json")),
    )
    return TiledEriEngine(port_sys, 1e-12, device="cpu")


@pytest.fixture(scope="module")
def water_631gs(water_631gs_port):
    """JAX and port tiled engines on water/6-31G*, screened at 1e-12."""
    jax_sys = JaxSystem.load(
        os.path.join(DATA, "mol", "water.json"),
        JaxBasisSet.load(os.path.join(DATA, "basis", "6-31G_st.json")),
    )
    return JaxEngine(jax_sys, 1e-12), water_631gs_port


@pytest.fixture(scope="module")
def water_631gs_sph(water_631gs):
    """Water/6-31G* in spherical AOs: the JAX engine's (ij|kl) and terms
    (screened at 1e-12, as the Cartesian fixture, whose integral programs
    it shares), the JAX pair builder's J and K of two random symmetric
    densities (its ``jk_sph`` sandwich; the JAX direct builder computes the
    same, tests/test_fock_stream.py), and the port's system."""
    jax_sys = JaxSystem.load(
        os.path.join(DATA, "mol", "water.json"),
        JaxBasisSet.load(os.path.join(DATA, "basis", "6-31G_st.json")), spherical=True,
    )
    eng = JaxEngine(jax_sys, 1e-12)
    e4 = np.asarray(eng.finish_eri(eng.build()))
    terms = np.asarray(eng.finish_terms(eng.build()))
    D = np.random.default_rng(21).standard_normal((2, 18, 18))
    D = D + D.transpose(0, 2, 1)
    builder = JaxPairBuilder(jax_sys, engine=eng, lean=False)
    JK = [builder.jk(jnp.asarray(d)) for d in D]
    port_sys = MolecularSystem.load(
        os.path.join(DATA, "mol", "water.json"),
        BasisSet.load(os.path.join(DATA, "basis", "6-31G_st.json")), spherical=True,
    )
    return port_sys, e4, terms, D, [tuple(np.asarray(x) for x in jk) for jk in JK]


def _rel(out, ref):
    return float(np.max(np.abs(np.asarray(out) - ref)) / max(np.max(np.abs(ref)), 1.0))


def test_spherical_finish_eri_and_terms_match_jax(water_631gs_sph):
    port_sys, e4_ref, terms_ref, _, _ = water_631gs_sph
    eng = TiledEriEngine(port_sys, 1e-12, device="cpu")
    e4 = eng.finish_eri(eng.build()).numpy()
    terms = eng.finish_terms(eng.build()).numpy()
    assert e4.shape == e4_ref.shape == (18,) * 4
    assert terms.shape == terms_ref.shape == (18 * 18,) * 2
    assert _rel(e4, e4_ref) <= 1e-12
    assert _rel(terms, terms_ref) <= 1e-12
    # symmetric to rounding, as kernel 2's half read needs
    assert np.abs(terms - terms.T).max() <= 1e-15 * np.abs(terms).max()


@pytest.mark.parametrize("builder", ["pair", "pair-lean", "direct"])
def test_spherical_jk_matches_jax(water_631gs_sph, builder):
    from qchem_rs_tpu_torch.ops.fock_pair import PairSpaceFockBuilder
    from qchem_rs_tpu_torch.ops.fock_stream import StreamingFockBuilder

    port_sys, _, _, D, JK = water_631gs_sph
    if builder == "direct":
        J, K = StreamingFockBuilder(port_sys, 1e-12, device="cpu").jk_stack(torch.tensor(D))
    else:
        b = PairSpaceFockBuilder(port_sys, 1e-12, device="cpu", lean=builder == "pair-lean")
        J, K = (torch.stack(x) for x in zip(*(b.jk(torch.tensor(d)) for d in D)))
    assert J.shape == K.shape == (2, 18, 18)
    for s in range(2):
        assert _rel(J[s], JK[s][0]) < 1e-11
        assert _rel(K[s], JK[s][1]) < 1e-11


def test_pair_groups_and_bounds_match_jax(water_631gs):
    jax_eng, port_eng = water_631gs
    assert len(port_eng.layout.groups) == len(jax_eng.layout.groups) == 6
    for jg, pg, jb, pb in zip(jax_eng.layout.groups, port_eng.layout.groups,
                              jax_eng._sorted_bounds, port_eng.bounds):
        ref = pair_group_from_numpy(
            jg.la, jg.lb, jg.i_shell, jg.j_shell, jg.ao_i, jg.ao_j,
            np.asarray(jg.E), np.asarray(jg.p), np.asarray(jg.P), "cpu",
        )
        assert (pg.la, pg.lb) == (ref.la, ref.lb)
        np.testing.assert_allclose(pb, np.asarray(jb), rtol=1e-12, atol=0)
        # bound-sorted pair order (ties may order differently): compare
        # the pair sets through their AO offsets and their tensors
        key = lambda g: np.lexsort((g.ao_j, g.ao_i))  # noqa: E731
        kp, kr = key(pg), key(ref)
        np.testing.assert_array_equal(pg.ao_i[kp], ref.ao_i[kr])
        np.testing.assert_array_equal(pg.ao_j[kp], ref.ao_j[kr])
        for name in ("E", "p", "P"):
            torch.testing.assert_close(
                getattr(pg, name)[kp], getattr(ref, name)[kr], rtol=0, atol=1e-13
            )


def test_twin_matches_jax_on_jax_pair_tensors(water_631gs):
    # identical real inputs: the JAX engine's sorted d-shell pair tensors,
    # padded by the port, through both tile twins
    jax_eng, _ = water_631gs
    jg = jax_eng.layout.groups[-1]  # (d, d) pairs
    g = pair_group_from_numpy(
        jg.la, jg.lb, jg.i_shell, jg.j_shell, jg.ao_i, jg.ao_j,
        np.asarray(jg.E), np.asarray(jg.p), np.asarray(jg.P), "cpu",
    )
    E, p, P = pad_group(g, 2)
    L = jg.la + jg.lb
    ref = np.asarray(jax_tile_vals(L, L, *(jnp.asarray(x.numpy()) for x in (E, p, P, E, p, P))))
    out = _tile_vals(L, L, E, p, P, E, p, P).numpy()
    assert np.max(np.abs(out - ref)) / np.max(np.abs(ref)) <= 1e-12


@pytest.fixture(scope="module")
def water_631gs_terms(water_631gs_port):
    """The port's RHF operator terms on water/6-31G*."""
    return water_631gs_port.finish_terms(water_631gs_port.build())


def test_finish_terms_matches_jax(water_631gs, water_631gs_terms):
    jax_eng, _ = water_631gs
    ref = np.asarray(jax_eng.finish_terms(jax_eng.build()))
    out = water_631gs_terms.numpy()
    assert out.shape == ref.shape == (19 * 19, 19 * 19)
    assert np.max(np.abs(out - ref)) / np.max(np.abs(ref)) <= 1e-11


def test_finish_terms_is_symmetric_for_the_half_read(water_631gs_terms):
    # kernel 2 reads only the block upper triangle of terms: the main
    # path's terms must be symmetric to rounding, and the product with its
    # upper triangle mirrored must equal terms @ d
    T = water_631gs_terms
    assert float((T - T.T).abs().max()) <= 1e-15 * float(T.abs().max())
    d = torch.tensor(np.random.default_rng(2).normal(size=T.shape[0]))
    ref = T @ d
    out = fock_matvec.matvec_upper_plain(T, d)
    assert float((out - ref).abs().max() / ref.abs().max()) <= 1e-13


def test_compacted_prims_come_first_with_their_counts(water_631gs_port):
    port_eng = water_631gs_port
    interleaved = []
    for g, m, (E, p, P), counts in zip(port_eng.layout.groups, port_eng.layout.metas,
                                       port_eng._padded, port_eng._counts):
        nz = E.reshape(E.shape[0], E.shape[1], -1).ne(0).any(-1)
        n = counts.n.to(torch.long)
        assert counts.n.dtype == torch.int32 and counts.n.shape == (m.npad,)
        assert torch.equal(nz, torch.arange(m.a)[None, :] < n[:, None])
        assert int(n[: m.npairs].min()) >= 1 and not bool(n[m.npairs:].any())
        # before compaction: were zero-E primitive pairs interleaved?
        nz0 = pad_group(g, m.npad)[0].reshape(m.npad, m.a, -1).ne(0).any(-1)
        assert torch.equal(nz0.sum(1), n)
        interleaved.append(bool((nz0[:, 1:] & ~nz0[:, :-1]).any()))
        # each tile block's ket points: the real ones first, ic-major
        T = m.tile
        for kb in range(m.npad // T):
            codes = counts.order[kb].to(torch.long)
            nreal = int(counts.nreal[kb])
            t, ic = codes % T, codes // T
            real = ic < n[kb * T + t]
            assert nreal == int(n[kb * T:(kb + 1) * T].sum())
            assert bool(real[:nreal].all()) and not bool(real[nreal:].any())
            assert torch.equal(codes[:nreal], codes[:nreal].sort().values)
    assert interleaved[:3] == [True, True, True]  # (s,s), (p,s), (p,p) of 6-31G*


def test_twin_on_compacted_prims_matches_original_order(water_631gs_port):
    port_eng = water_631gs_port
    metas, groups = port_eng.layout.metas, port_eng.layout.groups
    for i1, i2, ti, tj in port_eng._tasks[:: max(1, len(port_eng._tasks) // 6)]:
        m1, m2 = metas[i1], metas[i2]
        Lb, Lk = m1.la + m1.lb, m2.la + m2.lb
        E1, p1, P1 = pad_group(groups[i1], m1.npad)
        E2, p2, P2 = pad_group(groups[i2], m2.npad)
        ref = ket_contract(eri_kernel.bra_tiles_plain(
            Lb, Lk, E1, p1, P1, p2, P2, ti, tj, m1.tile, m2.tile), E2, tj, m2.tile)
        out = ket_contract(port_eng.bra_batch(i1, i2, ti, tj), port_eng._padded[i2][0],
                           tj, m2.tile)
        assert float((out - ref).abs().max() / ref.abs().max()) <= 1e-14


def test_batches_cover_every_tile_once(monkeypatch):
    # 4-pair tiles and small batches: each class pair's tiles come in
    # order, each once, over more batches than class pairs
    monkeypatch.setattr(eri_tiled, "TILE", 4)
    monkeypatch.setattr(eri_tiled, "BATCH_BYTES", 1 << 16)
    eng = TiledEriEngine(MolecularSystem.load(
        os.path.join(DATA, "mol", "water.json"),
        BasisSet.load(os.path.join(DATA, "basis", "6-31G_st.json")),
    ), 1e-12, device="cpu")
    assert max(len(ti) for _, _, ti, _ in eng._tasks) > 1
    got = {}
    nbatches = 0
    for i1, i2, ti, tj in eng.batches():
        nbatches += 1
        got.setdefault((i1, i2), []).extend(zip(ti.tolist(), tj.tolist()))
    assert nbatches > len(eng._tasks)
    assert got == {(i1, i2): list(zip(ti.tolist(), tj.tolist())) for i1, i2, ti, tj in eng._tasks}


def test_bra_kernel_work_counts_real_quartets(water_631gs_port):
    # bytes: the classes read once and every bra_tiles output
    # (nt, A, c*S2, T1, T2) written once; FLOPs: the per-quartet model over
    # the primitive quartets with nonzero E on both sides
    eng = water_631gs_port
    metas = eng.layout.metas
    real = [E.reshape(E.shape[0], E.shape[1], -1).ne(0).any(-1).sum(1).numpy()
            for E, _, _ in eng._padded]
    nbytes = sum(8 * (E.numel() + p.numel() + P.numel()) for E, p, P in eng._padded)
    flops = 0.0
    for i1, i2, ti, tj in eng._tasks:
        m1, m2 = metas[i1], metas[i2]
        Lb, Lk = m1.la + m1.lb, m2.la + m2.lb
        nbytes += 8 * len(ti) * m1.A * m2.a * nhermite(Lk) * m1.tile * m2.tile
        q = eri_tiled._quartet_flops(Lb + Lk, nhermite(Lb), nhermite(Lk), m1.A)
        for i, j in zip(ti, tj):
            flops += q * int(real[i1][i:i + m1.tile].sum()) * int(real[i2][j:j + m2.tile].sum())
    got_bytes, got_flops = eng.bra_kernel_work()
    assert got_bytes == nbytes
    assert abs(got_flops - flops) <= 1e-12 * flops
    padded = sum(eri_tiled._quartet_flops(metas[i1].la + metas[i1].lb + metas[i2].la + metas[i2].lb,
                                          nhermite(metas[i1].la + metas[i1].lb),
                                          nhermite(metas[i2].la + metas[i2].lb), metas[i1].A)
                 * len(ti) * metas[i1].tile * metas[i2].tile * metas[i1].a * metas[i2].a
                 for i1, i2, ti, _ in eng._tasks)
    assert got_flops < padded  # compaction leaves out the padded quartets


def test_prim_counts_need_compacted_prims():
    rng = np.random.default_rng(4)
    E = torch.tensor(rng.normal(size=(8, 3, 2, 4)))
    E[0, 0] = 0.0  # a zero-E primitive pair ahead of real ones
    p, P = torch.ones(8, 3), torch.zeros(8, 3, 3)
    with pytest.raises(ValueError, match="first"):
        eri_kernel.prim_counts(E, 4)
    Ec, pc, _ = eri_kernel.compact_prims(E, p.double(), P.double())
    assert torch.equal(Ec[0, :2], E[0, 1:]) and bool((Ec[0, 2] == 0).all())
    counts = eri_kernel.prim_counts(Ec, 4)
    assert counts.n.tolist() == [2] + [3] * 7 and counts.nreal.tolist() == [11, 12]


def test_all_prims_are_the_counts_of_a_full_class():
    # what the kernel gets when bra_tiles is called without counts: the
    # counts of a class whose primitive pairs are all real, which change
    # nothing in the result
    E1, p1, P1, E2, p2, P2 = (to_tensor(x, "cpu") for x in _random_tile(1, 2, 4, 3, 8, 4, seed=6))
    E1, p1, P1 = torch.cat([E1, E1]), torch.cat([p1, p1]), torch.cat([P1, P1])
    for E, T in ((E1, 8), (E2, 4)):
        want, got = eri_kernel.prim_counts(E, T), eri_kernel.all_prims(E.shape[0], E.shape[1], T, "cpu")
        for name in ("n", "order", "nreal"):
            assert torch.equal(getattr(got, name), getattr(want, name))
    ti, tj = np.array([0, 8]), np.array([0, 0])
    ref = eri_kernel.bra_tiles(1, 2, E1, p1, P1, p2, P2, ti, tj, 8, 4)
    out = eri_kernel.bra_tiles(1, 2, E1, p1, P1, p2, P2, ti, tj, 8, 4,
                               eri_kernel.all_prims(16, 4, 8, "cpu"), eri_kernel.all_prims(4, 3, 4, "cpu"))
    assert torch.equal(out, ref)


def _ragged_class(L, n, T, rng):
    """A padded class of 2T pairs of total angular momentum L with n
    primitive pairs each: zero-E primitive pairs interleaved, 1..n real per
    pair, the last pair all zero (a padding pair)."""
    A = ncart(L - L // 2) * ncart(L // 2)
    E = rng.standard_normal((2 * T, n, A, nhermite(L)))
    for i in range(2 * T):
        E[i, rng.permutation(n)[: n - rng.integers(1, n + 1)]] = 0.0
    E[-1] = 0.0
    return [torch.tensor(x) for x in (
        E, rng.uniform(0.3, 8.0, (2 * T, n)), rng.standard_normal((2 * T, n, 3)) * 1.5)]


@pytest.mark.parametrize("Lk", range(eri_kernel.HIGHL_MAX_SIDE + 1))
@pytest.mark.parametrize("Lb", range(eri_kernel.HIGHL_MAX_SIDE + 1))
def test_twin_with_ragged_counts_matches_original_order(Lb, Lk):
    # kernel 1's count contract on the CPU, for every (Lb, Lk) either part
    # of the kernel takes: after compaction, bra_tiles with counts writes
    # exact zeros past each ket pair's count, and the contracted integrals
    # equal those of the original primitive order
    rng = np.random.default_rng(200 + 5 * Lb + Lk)
    T, sizes = 4, [5, 4, 3, 2, 2, 2, 1]
    E1, p1, P1 = _ragged_class(Lb, sizes[Lb], T, rng)
    E2, p2, P2 = _ragged_class(Lk, sizes[Lk], T, rng)
    ti, tj = np.array([0, T, T]), np.array([T, 0, T])
    ref = ket_contract(eri_kernel.bra_tiles_plain(Lb, Lk, E1, p1, P1, p2, P2, ti, tj, T, T),
                       E2, tj, T)
    bra, ket = eri_kernel.compact_prims(E1, p1, P1), eri_kernel.compact_prims(E2, p2, P2)
    counts = eri_kernel.prim_counts(bra[0], T), eri_kernel.prim_counts(ket[0], T)
    out = eri_kernel.bra_tiles(Lb, Lk, *bra, *ket[1:], ti, tj, T, T, *counts)
    c, S2 = sizes[Lk], nhermite(Lk)
    n2 = counts[1].n.to(torch.long)[torch.as_tensor(tj[:, None] + np.arange(T))]  # (nt, T2)
    past = torch.arange(c)[None, :, None] >= n2[:, None, :]  # (nt, c, T2)
    per_prim = out.reshape(len(ti), -1, c, S2, T, T).permute(0, 2, 5, 1, 3, 4)
    assert bool((per_prim[past] == 0).all())
    out = ket_contract(out, ket[0], tj, T)
    assert float((out - ref).abs().max() / ref.abs().max()) <= 1e-13


@pytest.mark.parametrize("Lb,Lk", [(5, 0), (0, 5), (5, 3), (4, 6), (6, 6)])
def test_highl_plan_packs_the_recursion_and_gather(Lb, Lk):
    # the high-L part's device table, unpacked: the level sizes, then
    # mcmurchie._r_plan's recursion with R in level order (entries sorted
    # stably by their order t+u+v), then eri._r2_gather's indices in that
    # order and its signs
    from qchem_rs_tpu_torch.ops.eri import _r2_gather
    from qchem_rs_tpu_torch.ops.mcmurchie import _r_plan, hermite_components

    L, S1, S2 = Lb + Lk, nhermite(Lb), nhermite(Lk)
    plan = eri_kernel.highl_plan(Lb, Lk)
    H = nhermite(L)
    assert plan.dtype == np.int32 and plan.shape == (L + 1 + H + S1 * S2 + S2,)
    np.testing.assert_array_equal(plan[:L + 1], [nhermite(L - n) for n in range(L + 1)])
    order = np.sum(hermite_components(L), axis=1)
    entry = np.argsort(order, kind="stable")  # level-order position -> Hermite entry
    pos = np.argsort(entry)
    assert (np.diff(order[entry]) >= 0).all()
    steps = plan[L + 1:L + 1 + H].astype(np.int64)
    onehot, idx1, idx2, coef = _r_plan(L)
    np.testing.assert_array_equal(steps[1:] & 3, onehot[entry][1:].argmax(axis=1))
    np.testing.assert_array_equal((steps >> 2) & 15, coef[entry])
    np.testing.assert_array_equal((steps >> 6) & 511, pos[idx1[entry]])
    np.testing.assert_array_equal((steps >> 15) & 511, pos[idx2[entry]])
    assert ((steps >> 24) == 0).all()
    # every step reads only entries of lower order, which the level before holds
    for q in range(1, H):
        assert order[entry[(steps[q] >> 6) & 511]] == order[entry[q]] - 1
    idx, sign = _r2_gather(Lb, Lk)
    np.testing.assert_array_equal(plan[L + 1 + H:L + 1 + H + S1 * S2].reshape(S1, S2), pos[idx])
    np.testing.assert_array_equal(plan[L + 1 + H + S1 * S2:], sign < 0)


def _run_highl_row(Lb, Lk, sc, E1, p1, P1, p2, P2):
    """One (tile, t1) row of the high-L part executed in numpy from its
    host tables: its real ket points in groups of sc.W, one block each.
    E1 (nb, A, S1), p1 (nb,), P1 (nb, 3) the bra row's real primitives,
    p2 (r,), P2 (r, 3) its real ket points. Returns (A, S2, r) with the
    signs applied."""
    return np.concatenate([_run_highl_block(Lb, Lk, sc, E1, p1, P1, p2[j:j + sc.W], P2[j:j + sc.W])
                           for j in range(0, len(p2), sc.W)], axis=2)


def _run_highl_block(Lb, Lk, sc, E1, p1, P1, p2, P2):
    """One block of the high-L part in numpy, in the kernel's order: per
    split and per batch of bra primitives, Boys per (ket point, primitive)
    item, R level by level through the two ping-pong buffers of the plan's
    level order, then each thread's slices of the sums; the splits added in
    order. Its buffers are the block's shared memory at the schedule's
    capacities, whose bytes must be ``highl_smem_bytes``. Arguments as
    ``_run_highl_row``'s, with at most sc.W ket points."""
    from qchem_rs_tpu_torch.ops.boys import boys

    L, H, H1 = Lb + Lk, nhermite(Lb + Lk), nhermite(Lb + Lk - 1)
    S1, S2 = nhermite(Lb), nhermite(Lk)
    nb, A = E1.shape[:2]
    r = len(p2)
    plan = eri_kernel.highl_plan(Lb, Lk)
    lev, steps = plan[:L + 1], plan[L + 1:L + 1 + H]
    gat = plan[L + 1 + H:L + 1 + H + S1 * S2].reshape(S1, S2)
    sign = np.where(plan[L + 1 + H + S1 * S2:] == 1, -1.0, 1.0)
    A4, NI = -(-A // 4) * 4, sc.NI
    assert r <= sc.W <= NI and nb <= sc.nsplit * sc.ps
    kbd = max(1, min(sc.KB, NI // r))
    # shared memory: staged E1, two R level buffers, Boys base, PC, sums;
    # the plan's ints (level sizes, steps, sign flags), two ints a column
    # and the gather's shorts
    E1s_mem, acc_mem = np.zeros(sc.KB * S1 * A4), np.zeros(sc.W * A * S2)
    R = [np.zeros((H, NI)), np.zeros((H1, NI))]
    Fb, PCb = np.zeros((L + 1, NI)), np.zeros((3, NI))
    nbytes = sum(x.nbytes for x in (E1s_mem, acc_mem, *R, Fb, PCb)) \
        + 4 * (len(lev) + len(steps) + S2 + 2 * sc.W) + 2 * gat.size
    assert -(-nbytes // 16) * 16 == eri_kernel.highl_smem_bytes(Lb, Lk, A, sc)
    total = np.zeros((A, S2, r))
    for split in range(sc.nsplit):
        acc = acc_mem[:A * S2 * r]  # (alpha, s2, ket point), ket points fastest
        acc[:] = 0.0
        ia_end = min(nb, (split + 1) * sc.ps)
        for ia0 in range(split * sc.ps, ia_end, kbd):
            nbat = min(kbd, ia_end - ia0)
            items = nbat * r
            E1s = E1s_mem[:nbat * S1 * A4].reshape(nbat, S1, A4)
            E1s[:, :, :A] = E1[ia0:ia0 + nbat].transpose(0, 2, 1)
            ia, j = np.divmod(np.arange(items), r)
            p, q = p1[ia0 + ia], p2[j]
            PC = P1[ia0 + ia] - P2[j]  # (items, 3)
            al = p * q / (p + q)
            F = boys(L, torch.tensor(al * (PC**2).sum(axis=1))).numpy()
            Fb[:, :items] = F * (2 * np.pi**2.5 / (p * q * np.sqrt(p + q)))[None] \
                * (-2 * al)[None] ** np.arange(L + 1)[:, None]
            PCb[:, :items] = PC.T
            for x in R:
                x.fill(np.nan)
            R[L & 1][0, :items] = Fb[L, :items]
            for n in range(L - 1, -1, -1):
                dst, src = R[n & 1], R[(n + 1) & 1]
                for qd in range(lev[n]):
                    if qd == 0:
                        dst[0, :items] = Fb[n, :items]
                        continue
                    st = int(steps[qd])
                    dst[qd, :items] = (PCb[st & 3, :items] * src[(st >> 6) & 511, :items]
                                       + ((st >> 2) & 15) * src[(st >> 15) & 511, :items])
            for t in range(sc.NT):
                for sl in range(t, r * S2 * (A4 // 4), sc.NT):
                    jj, rest = sl % r, sl // r
                    s2, a0 = rest % S2, rest // S2 * 4
                    for u in range(min(4, A - a0)):
                        o = ((a0 + u) * S2 + s2) * r + jj
                        for b in range(nbat):
                            acc[o] += E1s[b, :, a0 + u] @ R[0][gat[:, s2], b * r + jj]
        total += acc.reshape(A, S2, r)
    return total * sign[None, :, None]


@pytest.mark.parametrize("Lb,Lk", [(0, 5), (1, 5), (2, 5), (5, 3), (4, 5), (5, 5), (6, 5), (6, 6)])
def test_highl_schedule_executed_in_numpy_matches_jax_r_table(Lb, Lk):
    # L = 5 ... 12: the high-L part's tables and launch shapes, executed in
    # numpy as the kernel runs them, against the JAX package's r_table and
    # its _r2_gather contraction; once with the schedule of a few-block
    # class (the bra loop split over blocks), once with that of a class of
    # many tiles, and once with batches of two bra primitives
    import dataclasses

    from qchem_rs_tpu.ops.eri import _r2_gather as jax_r2_gather
    from qchem_rs_tpu.ops.mcmurchie import r_table as jax_r_table

    rng = np.random.default_rng(500 + 7 * Lb + Lk)
    L, S1, S2 = Lb + Lk, nhermite(Lb), nhermite(Lk)
    A = max(ncart(Lb - lb) * ncart(lb) for lb in range(Lb // 2 + 1))
    nb, r = 5, 3
    E1 = rng.standard_normal((nb, A, S1))
    p1, p2 = rng.uniform(0.3, 8.0, nb), rng.uniform(0.3, 8.0, r)
    P1, P2 = rng.standard_normal((nb, 3)) * 1.5, rng.standard_normal((r, 3)) * 1.5

    alpha = p1[:, None] * p2[None, :] / (p1[:, None] + p2[None, :])
    R = np.asarray(jax_r_table(L, jnp.asarray(alpha), jnp.asarray(P1[:, None] - P2[None])))
    pref = 2 * np.pi**2.5 / (p1[:, None] * p2[None] * np.sqrt(p1[:, None] + p2[None]))
    idx, sign = jax_r2_gather(Lb, Lk)
    R2 = R[..., idx] * sign * pref[..., None, None]  # (nb, r, S1, S2)
    ref = np.einsum("iAs,ijst->Atj", E1, R2)

    few = eri_kernel.highl_schedule(Lb, Lk, nb, 1, A, 4, r, 1, 132)
    many = eri_kernel.highl_schedule(Lb, Lk, nb, 1, A, 32, r, 40, 132)
    assert few.nsplit > 1 and many.nsplit == 1
    for sc in (few, many, dataclasses.replace(many, KB=2, NI=2 * many.W)):
        out = _run_highl_row(Lb, Lk, sc, E1, p1, P1, p2, P2)
        assert float(np.abs(out - ref).max() / np.abs(ref).max()) <= 1e-12


def test_bra_kernel_work_of_a_subset_of_class_pairs(water_631gs_port):
    # the work of a subset is that of its class pairs alone: their outputs
    # and quartets, and only the classes they read
    eng = water_631gs_port
    total = eng.bra_kernel_work()
    d_pairs = eng.bra_kernel_work(lambda Lb, Lk: max(Lb, Lk) >= 2)
    rest = eng.bra_kernel_work(lambda Lb, Lk: max(Lb, Lk) < 2)
    assert abs(d_pairs[1] + rest[1] - total[1]) <= 1e-12 * total[1]
    inputs = sum(8.0 * (E.numel() + p.numel() + P.numel()) for E, p, P in eng._padded)
    assert d_pairs[0] + rest[0] > total[0] > inputs  # both subsets read some classes
    assert eng.bra_kernel_work(lambda Lb, Lk: False) == (0.0, 0.0)
    assert 0 < d_pairs[1] < total[1]


def test_bra_kernel_work_of_chosen_class_pairs(water_631gs_port):
    # class pair by class pair, the FLOPs add up to the whole build's, each
    # pair's bytes are its outputs and the one or two classes it reads, and
    # a selection by (Lb, Lk) narrows the chosen pairs further
    eng = water_631gs_port
    total = eng.bra_kernel_work()
    pairs = sorted({t[:2] for t in eng._tasks})
    assert len(pairs) > 1
    each = [eng.bra_kernel_work(pairs={p}) for p in pairs]
    assert abs(sum(f for _, f in each) - total[1]) <= 1e-12 * total[1]
    for (i1, i2), (nbytes, _) in zip(pairs, each):
        read = sum(8.0 * sum(x.numel() for x in eng._padded[i]) for i in {i1, i2})
        assert nbytes > read
    assert eng.bra_kernel_work(pairs=set()) == (0.0, 0.0)
    assert eng.bra_kernel_work(lambda Lb, Lk: False, pairs=set(pairs)) == (0.0, 0.0)
    assert eng.bra_kernel_work(pairs=set(pairs)) == total


def _tiny_f_systems():
    """Two atoms with one s and one f shell each (22 Cartesian AOs): the
    smallest whole system whose ERIs reach (ff|ff), L = 12, in both
    packages."""
    from qchem_rs_tpu.utils.basis import ShellSpec as JaxShellSpec
    from qchem_rs_tpu.utils.system import Atom as JaxAtom
    from qchem_rs_tpu_torch.utils.basis import ShellSpec
    from qchem_rs_tpu_torch.utils.system import Atom

    specs = [(0, [3.0, 0.6], [0.4, 0.7]), (3, [1.1], [1.0])]
    pos = [np.array([0.0, 0.1, -0.2]), np.array([1.1, -0.3, 0.9])]
    jb = JaxBasisSet("tiny-f", {8: [JaxShellSpec(l=l, exponents=np.array(e), coefficients=np.array(c))
                                    for l, e, c in specs]})
    pb = BasisSet("tiny-f", {8: [ShellSpec(l=l, exponents=np.array(e), coefficients=np.array(c))
                                 for l, e, c in specs]})
    return JaxSystem([JaxAtom(8, x) for x in pos], jb), MolecularSystem([Atom(8, x) for x in pos], pb)


@pytest.fixture(scope="module")
def f_shell_jax_eri():
    """The JAX engine's (ij|kl) of ``_tiny_f_systems`` (its XLA f64 path
    beyond L = 8; about 10 s of JAX compiling on one core), and the port's
    system."""
    jax_sys, port_sys = _tiny_f_systems()
    jeng = JaxEngine(jax_sys, 0.0)
    return np.asarray(jeng.finish_eri(jeng.build())), port_sys


def test_f_shell_eri_matches_jax(f_shell_jax_eri):
    # every class pair up to (ff|ff) through the twin and the port's pair
    # space against the JAX engine's
    ref, port_sys = f_shell_jax_eri
    eng = TiledEriEngine(port_sys, 0.0, device="cpu")
    assert max(m.la + m.lb for m in eng.layout.metas) == 6
    out = eng.finish_eri(eng.build()).numpy()
    assert out.shape == ref.shape == (22,) * 4
    assert np.max(np.abs(out - ref)) / np.max(np.abs(ref)) <= 1e-12


def test_f_shell_direct_jk_matches_jax(f_shell_jax_eri):
    # the direct pass on the CPU for class pairs up to (ff|ff): every batch
    # goes through the engine's values_batch (kernel 3's twin here, its
    # high-L part on the card), none through kernel 1; J and K of a random
    # symmetric density against J and K contracted in numpy from the JAX
    # engine's (ij|kl), to 1e-11 relative (sums in another order)
    from qchem_rs_tpu_torch.ops.fock_stream import StreamingFockBuilder

    ref, port_sys = f_shell_jax_eri
    n = ref.shape[0]
    D = np.random.default_rng(11).standard_normal((n, n))
    D = D + D.T
    J_ref = np.einsum("ijkl,kl->ij", ref, D)
    K_ref = np.einsum("ikjl,kl->ij", ref, D)
    builder = StreamingFockBuilder(port_sys, 0.0, device="cpu")
    eng = builder.engine
    calls = []
    values_batch = eng.values_batch
    eng.values_batch = lambda *a, **k: calls.append(a[:2]) or values_batch(*a, **k)
    eng.bra_batch = None  # the direct pass has one route
    metas = eng.layout.metas
    assert any(max(metas[i1].la + metas[i1].lb, metas[i2].la + metas[i2].lb) > 4
               for i1, i2, _, _ in builder.batches)
    J, K = builder.jk(torch.tensor(D))
    assert calls == [b[:2] for b in builder.batches]
    assert np.abs(J.numpy() - J_ref).max() <= 1e-11 * np.abs(J_ref).max()
    assert np.abs(K.numpy() - K_ref).max() <= 1e-11 * np.abs(K_ref).max()
