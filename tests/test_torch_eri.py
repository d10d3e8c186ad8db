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
from qchem_rs_tpu.ops.eri_tiled import _tile_vals as _jax_tile_vals_eager
from qchem_rs_tpu.utils.basis import BasisSet as JaxBasisSet
from qchem_rs_tpu.utils.system import MolecularSystem as JaxSystem
from qchem_rs_tpu_torch.ops import eri_kernel
from qchem_rs_tpu_torch.ops.angular import ncart
from qchem_rs_tpu_torch.ops.eri_tiled import TiledEriEngine, _tile_vals, mirror_inplace, pad_group
from qchem_rs_tpu_torch.ops.mcmurchie import nhermite
from qchem_rs_tpu_torch.utils.basis import BasisSet
from qchem_rs_tpu_torch.utils.interop import pair_group_from_numpy, to_tensor
from qchem_rs_tpu_torch.utils.system import MolecularSystem

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


def test_mirror_inplace_fills_lower_triangle():
    rng = np.random.default_rng(5)
    full = rng.standard_normal((37, 37))
    full = full + full.T
    V2 = torch.tensor(np.triu(full))
    out = mirror_inplace(V2, block=8)
    assert out is V2
    np.testing.assert_array_equal(out.numpy(), full)


@pytest.fixture(scope="module")
def water_631gs():
    """JAX and port tiled engines on water/6-31G* (d shells), screened at
    1e-12 as the RHF default."""
    jax_sys = JaxSystem.load(
        os.path.join(DATA, "mol", "water.json"),
        JaxBasisSet.load(os.path.join(DATA, "basis", "6-31G_st.json")),
    )
    port_sys = MolecularSystem.load(
        os.path.join(DATA, "mol", "water.json"),
        BasisSet.load(os.path.join(DATA, "basis", "6-31G_st.json")),
    )
    return JaxEngine(jax_sys, 1e-12), TiledEriEngine(port_sys, 1e-12, device="cpu")


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


def test_finish_terms_matches_jax(water_631gs):
    jax_eng, port_eng = water_631gs
    ref = np.asarray(jax_eng.finish_terms(jax_eng.build()))
    out = port_eng.finish_terms(port_eng.build()).numpy()
    assert out.shape == ref.shape == (19 * 19, 19 * 19)
    assert np.max(np.abs(out - ref)) / np.max(np.abs(ref)) <= 1e-11
