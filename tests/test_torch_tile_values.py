"""Port parity, kernel 3 (the direct pass's tile values): its plain twin
``eri_kernel.tile_values_plain`` against the JAX package's plain tile
function ``eri_tiled._tile_vals`` on the CPU, for every (Lb, Lk) <= (4, 4),
with ragged primitive counts and padded pairs; the CPU dispatch and input
checks of ``tile_values``; and the engine's batch rule for it.

The JAX Pallas bodies do not run in interpret mode here (see
tests/test_torch_eri.py), so ``_tile_vals`` is the reference. Kernel 3
itself runs only on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qchem_rs_tpu.ops.eri_tiled import _tile_vals as _jax_tile_vals_eager
from qchem_rs_tpu_torch import BasisSet, MolecularSystem
from qchem_rs_tpu_torch.ops import eri_kernel, eri_tiled
from qchem_rs_tpu_torch.ops.angular import ncart
from qchem_rs_tpu_torch.ops.mcmurchie import nhermite
from tests.torch_threads import one_torch_thread  # noqa: F401

DATA = os.path.join(os.path.dirname(__file__), "..", "data")

#: the JAX tile function as one compiled program per (Lb, Lk)
jax_tile_vals = jax.jit(_jax_tile_vals_eager, static_argnums=(0, 1))


def _class(rng, L, n, N, X, zero_rows, npad):
    """A padded, compacted class of N real pairs and npad - N padding pairs
    (E = 0, p = 1, P = 0, as ``eri_tiled.pad_group`` pads), n primitive
    pairs each, zero-E primitive pairs interleaved (counts 1..n), the last
    ``zero_rows`` real pairs without any real primitive pair."""
    E = rng.standard_normal((N, n, X, nhermite(L)))
    for i in range(N):
        E[i, rng.permutation(n)[: n - rng.integers(1, n + 1)]] = 0.0
    E[N - zero_rows:] = 0.0
    pad = npad - N
    E = np.concatenate([E, np.zeros((pad,) + E.shape[1:])])
    p = np.concatenate([rng.uniform(0.3, 8.0, (N, n)), np.ones((pad, n))])
    P = np.concatenate([rng.standard_normal((N, n, 3)) * 1.5, np.zeros((pad, n, 3))])
    return eri_kernel.compact_prims(*(torch.tensor(x) for x in (E, p, P)))


def _case(Lb, Lk, T=4):
    rng = np.random.default_rng(700 + Lb * 5 + Lk)
    prims = [4, 3, 2, 2, 1, 2, 1]
    comps = [[ncart(L - lb) * ncart(lb) for lb in range(L // 2 + 1)] for L in (Lb, Lk)]
    A, C = comps[0][-1], comps[1][0]
    E1, p1, P1 = _class(rng, Lb, prims[Lb], 2 * T - 1, A, 2, 2 * T)
    E2, p2, P2 = _class(rng, Lk, prims[Lk], 2 * T - 2, C, 0, 2 * T)
    counts = eri_kernel.prim_counts(E1, T), eri_kernel.prim_counts(E2, T)
    ti, tj = np.array([0, T, T, 0]), np.array([T, 0, T, 0])
    return (E1, p1, P1, E2, p2, P2), counts, ti, tj, T


#: f-shell class pairs (a side of 5 or 6): four in the TPU kernels' L <= 8
#: domain, and one past it (the JAX package's XLA f64 path there)
HIGHL_CASES = [(5, 0), (0, 5), (5, 3), (6, 2), (4, 5)]


@pytest.mark.parametrize("Lb,Lk", [(lb, lk) for lb in range(5) for lk in range(5)] + HIGHL_CASES)
def test_tile_values_twin_matches_jax_tile_vals(Lb, Lk):
    (E1, p1, P1, E2, p2, P2), (bra, ket), ti, tj, T = _case(Lb, Lk)
    # the case holds ragged counts, pairs without a real primitive pair and padding
    assert bra.n.min() == 0 and ket.n.min() == 0 and len(set(bra.n.tolist())) > 1
    out = eri_kernel.tile_values_plain(Lb, Lk, E1, p1, P1, E2, p2, P2, ti, tj, T, T, bra, ket)
    assert out.shape == (len(ti), T * E1.shape[2], T * E2.shape[2])
    for k, (i, j) in enumerate(zip(ti, tj)):
        ref = np.asarray(jax_tile_vals(Lb, Lk, *(jnp.asarray(x[s : s + T].numpy()) for x, s in (
            (E1, i), (p1, i), (P1, i), (E2, j), (p2, j), (P2, j)))))
        assert np.abs(out[k].numpy() - ref).max() <= 1e-12 * max(np.abs(ref).max(), 1e-300)


def test_tile_values_on_cpu_takes_twin_and_checks_inputs():
    args, (bra, ket), ti, tj, T = _case(2, 1)
    E1, p1, P1, E2, p2, P2 = args
    before = eri_kernel.VALUES_KERNEL.launches
    out = eri_kernel.tile_values(2, 1, *args, ti, tj, T, T, bra, ket)
    assert torch.equal(out, eri_kernel.tile_values_plain(2, 1, *args, ti, tj, T, T, bra, ket))
    assert eri_kernel.VALUES_KERNEL.launches == before  # CPU tensors never launch
    # without counts every primitive pair counts as real: the same values,
    # since zero-E primitive pairs add exactly zero
    free = eri_kernel.tile_values(2, 1, *args, ti, tj, T, T)
    assert float((free - out).abs().max()) <= 1e-13 * float(out.abs().max())
    with pytest.raises(ValueError, match="Lk=2"):
        eri_kernel.tile_values(2, 2, *args, ti, tj, T, T, bra, ket)
    with pytest.raises(ValueError, match="E2"):
        eri_kernel.tile_values(2, 1, E1, p1, P1, E2[:-1].contiguous(), p2, P2, ti, tj, T, T)
    with pytest.raises(ValueError, match="contiguous float64"):
        eri_kernel.tile_values(2, 1, E1, p1, P1, E2.float(), p2, P2, ti, tj, T, T)
    with pytest.raises(ValueError, match="outside"):
        eri_kernel.tile_values(2, 1, *args, np.array([2 * T]), np.array([0]), T, T)


@pytest.fixture(scope="module")
def methane_engine():
    mpath = os.path.join(DATA, "mol", "methane.json")
    system = MolecularSystem.load(mpath, BasisSet.load(os.path.join(DATA, "basis", "6-31G.json")))
    return eri_tiled.TiledEriEngine(system, 1e-12, device="cpu")


def _f_shell_system():
    """Two atoms with an s, p, d and f shell each (40 Cartesian AOs): class
    pairs up to (ff|ff), with both of kernel 3's parts."""
    from qchem_rs_tpu_torch.utils.basis import ShellSpec
    from qchem_rs_tpu_torch.utils.system import Atom

    specs = [(0, [3.0, 0.6], [0.4, 0.7]), (1, [1.3, 0.4], [0.6, 0.5]), (2, [0.9], [1.0]),
             (3, [1.1], [1.0])]
    basis = BasisSet("spdf", {8: [ShellSpec(l=l, exponents=np.array(e), coefficients=np.array(c))
                                  for l, e, c in specs]})
    return MolecularSystem([Atom(8, np.array([0.0, 0.1, -0.2])), Atom(8, np.array([1.1, -0.3, 0.9]))],
                           basis)


@pytest.fixture(scope="module")
def f_shell_engine():
    return eri_tiled.TiledEriEngine(_f_shell_system(), 1e-12, device="cpu")


@pytest.mark.parametrize("twin", [None, False])
def test_kernel3_batch_rule(methane_engine, f_shell_engine, twin):
    # on the card (twin False) kernel 3's batches are sized for its finished
    # blocks, T1*A*T2*C doubles a tile, in both of its parts (the f-shell
    # class pairs of the second engine take the high-L part), and so hold at
    # least as many tiles as kernel 1's wherever a ket pair's C components
    # are no more than its c*S2 bra-contracted entries (every class pair of
    # methane); on the CPU (twin None) both take the twin's rule
    highl = 0
    for eng in (methane_engine, f_shell_engine):
        for i1, i2, _, _ in eng._tasks:
            m1, m2 = eng.layout.metas[i1], eng.layout.metas[i2]
            highl += max(m1.la + m1.lb, m2.la + m2.lb) > eri_kernel.KERNEL_MAX_SIDE
            step = eng.batch_step(i1, i2, twin, values=True)
            if twin is None:
                assert step == eng.batch_step(i1, i2, True) == eng.batch_step(i1, i2)
            else:
                assert step == eri_tiled.BATCH_BYTES // (8 * m1.tile * m2.tile * m1.A * m2.A)
                if m2.A <= m2.a * nhermite(m2.la + m2.lb) or eng is methane_engine:
                    assert step >= eng.batch_step(i1, i2, False)
        tiles = sum(len(ti) for _, _, ti, _ in eng._tasks)
        assert sum(len(b[2]) for b in eng.batches(twin, values=True)) == tiles
    assert highl >= 10


def test_kernel3_work_counts_both_dots(methane_engine):
    # kernel 3 writes the finished blocks and does the ket dot on top of
    # kernel 1's arithmetic
    eng = methane_engine
    nb1, nf1 = eng.bra_kernel_work()
    nb3, nf3 = eng.values_kernel_work()
    assert nb3 < nb1 and nf3 > nf1
    blocks = sum(8.0 * len(ti) * eng.layout.metas[i1].tile * eng.layout.metas[i2].tile
                 * eng.layout.metas[i1].A * eng.layout.metas[i2].A for i1, i2, ti, _ in eng._tasks)
    inputs = sum(8.0 * (E.numel() + p.numel() + P.numel()) for E, p, P in eng._padded)
    assert nb3 == pytest.approx(inputs + blocks, rel=1e-15)


@pytest.mark.parametrize("real_first", [True, False])
def test_ket_positions_invert_the_ket_order(real_first):
    # kernel 3's row kernel finds each ket point (ic, t2) of a ket tile block
    # in korder through kpos: the two are inverse permutations, for counts
    # of a compacted class and for every primitive pair taken as real
    T = 4
    if real_first:
        E = _class(np.random.default_rng(3), 1, 3, 2 * T - 1, 3, 1, 2 * T)[0]
        counts = eri_kernel.prim_counts(E, T)
    else:
        counts = eri_kernel.all_prims(2 * T, 3, T, "cpu")
    order, pos = counts.order.long(), counts.pos.long()
    ar = torch.arange(order.shape[1]).expand_as(order)
    assert torch.equal(torch.take_along_dim(pos, order, dim=1), ar)
    assert torch.equal(torch.take_along_dim(order, pos, dim=1), ar)


def _run_values_highl(Lb, Lk, sc, args, bra, ket, ti, tj, T1, T2):
    """Kernel 3's high-L part executed in numpy as its blocks run it under
    the launch shape ``sc``: per (tile, t1, ket group, alpha chunk) block,
    the group's real ket points listed ic-major through per-ic masks and
    offsets, walked in chunks of W, each chunk's bra sums over batches of
    bra primitives, signed, then added per ket pair over the chunk's ket
    points in ascending ic. R comes from one vectorized table of every
    primitive quartet."""
    from qchem_rs_tpu_torch.ops.eri import _r2_gather
    from qchem_rs_tpu_torch.ops.mcmurchie import r_table_components

    E1, p1, P1, E2, p2, P2 = (x.numpy() for x in args)
    n1, n2 = bra.n.numpy(), ket.n.numpy()
    A, C, S2 = E1.shape[2], E2.shape[2], E2.shape[3]
    pp, qq = p1[:, :, None, None], p2[None, None]
    PQ = [torch.tensor(P1[:, :, None, None, d] - P2[None, None, :, :, d]) for d in range(3)]
    R = r_table_components(Lb + Lk, torch.tensor(pp * qq / (pp + qq)), *PQ).numpy()
    R = R * 2 * np.pi**2.5 / (pp * qq * np.sqrt(pp + qq))  # (H, N1, a, N2, c)
    idx, sign = _r2_gather(Lb, Lk)
    out = np.full((len(ti), T1 * A, T2 * C), np.nan)
    for tile in range(len(ti)):
        for t1 in range(T1):
            row, nb = ti[tile] + t1, n1[ti[tile] + t1]
            for g0 in range(0, T2, sc.G):
                for alpha0 in range(0, A, sc.Ah):
                    nal, gv = min(sc.Ah, A - alpha0), min(sc.G, T2 - g0)
                    n2s = [n2[tj[tile] + g0 + t] if nb > 0 else 0 for t in range(gv)]
                    nk = max(n2s)
                    mask = [[t for t in range(gv) if n2s[t] > ic] for ic in range(nk + 1)]
                    off = [sum(min(x, ic) for x in n2s) for ic in range(nk + 1)]
                    O = np.zeros((nal, gv, C))
                    for k0 in range(0, off[nk], sc.W):
                        pts = []
                        for k in range(k0, min(k0 + sc.W, off[nk])):
                            ic = 0
                            while off[ic + 1] <= k:
                                ic += 1
                            pts.append((mask[ic][k - off[ic]], ic))
                        W = np.zeros((len(pts), nal, S2))
                        kbd = max(1, min(sc.KB, sc.NI // len(pts)))
                        for ia0 in range(0, nb, kbd):
                            for ia in range(ia0, min(nb, ia0 + kbd)):
                                e = E1[row, ia, alpha0:alpha0 + nal]  # (nal, S1)
                                for j, (t, ic) in enumerate(pts):
                                    W[j] += e @ R[:, row, ia, tj[tile] + g0 + t, ic][idx]
                        W *= sign
                        for j, (t, ic) in enumerate(pts):
                            O[:, t] += W[j] @ E2[tj[tile] + g0 + t, ic].T
                    out[tile, t1 * A + alpha0:t1 * A + alpha0 + nal,
                        g0 * C:(g0 + gv) * C] = O.reshape(nal, gv * C)
    return out


@pytest.mark.parametrize("Lb,Lk", [(0, 5), (5, 1), (3, 6), (6, 2)])
def test_values_highl_schedule_executed_in_numpy_matches_twin(Lb, Lk):
    # the high-L part's block decomposition, ket point listing and
    # summation order, run in numpy, against the twin on ragged classes
    # (counts, pairs without a real primitive pair, padding) under its own
    # launch shape, one of a single ket pair and ket point at a time in
    # chunks of four alphas, and one of batches of one bra primitive
    import dataclasses

    args, (bra, ket), ti, tj, T = _case(Lb, Lk)
    ref = eri_kernel.tile_values_plain(Lb, Lk, *args, ti, tj, T, T, bra, ket).numpy()
    A, C = args[0].shape[2], args[3].shape[2]
    sc = eri_kernel.values_highl_schedule(Lb, Lk, args[0].shape[1], args[3].shape[1], A, C, T, T,
                                          len(ti), 132)
    for s in (sc, dataclasses.replace(sc, Ah=min(4, A), G=1, W=1, NI=1, KB=1),
              dataclasses.replace(sc, W=2, NI=2, KB=1)):
        out = _run_values_highl(Lb, Lk, s, args, bra, ket, ti, tj, T, T)
        assert float(np.abs(out - ref).max() / np.abs(ref).max()) <= 1e-12


def test_values_highl_schedule_fits_the_card():
    # every high-L class pair, from both sides, at the primitive and tile
    # counts of real bases: the block's shared memory fits an H100's
    # 232448 bytes a block, its threads the kernel's launch bounds, and
    # the value and chunk sizes the kernel's limits
    worst = 0
    for Lb in range(7):
        for Lk in range(7):
            if max(Lb, Lk) <= eri_kernel.KERNEL_MAX_SIDE:
                continue
            A = max(ncart(Lb - lb) * ncart(lb) for lb in range(Lb // 2 + 1))
            C = max(ncart(Lk - lk) * ncart(lk) for lk in range(Lk // 2 + 1))
            for a, c, T1, T2, nt in ((1, 1, 1, 1, 1), (36, 81, 32, 32, 400), (81, 3, 16, 32, 2),
                                     (6, 36, 32, 1, 45)):
                sc = eri_kernel.values_highl_schedule(Lb, Lk, a, c, A, C, T1, T2, nt, 132)
                assert 1 <= sc.Ah <= A and 1 <= sc.G <= min(T2, 32) and sc.NI >= sc.W >= 1
                assert 64 <= sc.NT <= eri_kernel.VALUES_HIGHL_MAX_THREADS and sc.NT % 32 == 0
                worst = max(worst, eri_kernel.values_highl_smem_bytes(Lb, Lk, c, C, sc))
    assert worst <= 232448
