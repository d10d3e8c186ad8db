"""Port parity, nuclear gradients: the port's ``rhf_gradient`` (in core),
``rhf_gradient_pair`` and ``uhf_gradient`` against the JAX package's on
the same molecules, each package from its own SCF at a tight stop; the
port's three Fock modes against each other; a spherical gradient against
the port's own central difference of the energy; translation invariance;
and the errors for a field and an unconverged SCF. Beneath them: the
level-order R recursion against the full-table one it replaced (equal
bits), the R table's backward from the table at L + 1 against autograd
through the recursion, and the engine's operands rebuilt at its own
geometry (equal bits).

Three JAX gradient programs in all, one per module fixture (each costs
tens of seconds to trace and compile)."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from qchem_rs_tpu import HartreeFockConfig as JaxConfig
from qchem_rs_tpu.models import gradients as jax_gradients
from qchem_rs_tpu.models import gradients_pair as jax_gradients_pair
from qchem_rs_tpu.utils.basis import BasisSet as JaxBasisSet
from qchem_rs_tpu.utils.system import MolecularSystem as JaxSystem
from qchem_rs_tpu_torch import (BasisSet, HartreeFockConfig, MolecularSystem,
                                restricted_hartree_fock, rhf_gradient, rhf_gradient_pair,
                                uhf_gradient, unrestricted_hartree_fock)
from qchem_rs_tpu_torch.models.gradients import is_open_shell, scf_and_gradient
from qchem_rs_tpu_torch.ops import mcmurchie
from qchem_rs_tpu_torch.ops.eri_tiled import TiledEriEngine
from tests.torch_threads import one_torch_thread  # noqa: F401

DATA = os.path.join(os.path.dirname(__file__), "..", "data")
MODES = ("incore", "pair", "direct")


def _systems(mol, basis, spherical=False):
    mpath = os.path.join(DATA, "mol", f"{mol}.json")
    bpath = os.path.join(DATA, "basis", f"{basis}.json")
    return (MolecularSystem.load(mpath, BasisSet.load(bpath), spherical=spherical),
            JaxSystem.load(mpath, JaxBasisSet.load(bpath), spherical=spherical))


@pytest.fixture(scope="module")
def water_sto3g():
    """Water/STO-3G: the JAX package's dense gradient from its own SCF at
    diag_rms 1e-11."""
    port, jsys = _systems("water", "STO-3G")
    ref = jax_gradients.rhf_gradient(jsys, JaxConfig(epsilon=1e-11, max_iterations=200))
    return port, ref


@pytest.fixture(scope="module")
def water_631g():
    """Water/6-31G: the JAX package's pair-space gradient from its own pair
    SCF at diag_rms 1e-11, and the port's gradient in each Fock mode."""
    port, jsys = _systems("water", "6-31G")
    ref = jax_gradients_pair.rhf_gradient_pair(
        jsys, JaxConfig(epsilon=1e-11, max_iterations=200, fock_mode="pair"))
    cfg = HartreeFockConfig(epsilon=1e-11, max_iterations=200)
    ours = {mode: rhf_gradient(port, dataclasses.replace(cfg, fock_mode=mode), device="cpu")
            for mode in MODES}
    return port, ref, ours


@pytest.fixture(scope="module")
def hydroxyl():
    """OH/STO-3G doublet: the JAX package's UHF gradient from its own SCF at
    diag_rms 1e-12 (UHF's stop can land on a rounding-chosen dip above it)."""
    port, jsys = _systems("hydroxyl", "STO-3G")
    ref = jax_gradients.uhf_gradient(
        jsys, JaxConfig(epsilon=1e-12, max_iterations=400, spin_multiplicity=2))
    return port, ref


def test_rhf_gradient_matches_jax(water_sto3g):
    port, ref = water_sto3g
    g = rhf_gradient(port, HartreeFockConfig(epsilon=1e-11, max_iterations=200), device="cpu")
    assert g.shape == (3, 3)
    assert np.abs(g - ref).max() <= 1e-8  # Eh/Bohr


def test_rhf_gradient_pair_matches_jax(water_631g):
    port, ref, _ = water_631g
    g = rhf_gradient_pair(port, HartreeFockConfig(epsilon=1e-11, max_iterations=200),
                          device="cpu")
    assert np.abs(g - ref).max() <= 1e-8  # Eh/Bohr


@pytest.mark.parametrize("mode", ["pair", "direct"])
def test_fock_modes_agree(water_631g, mode):
    _, _, ours = water_631g
    assert np.abs(ours[mode] - ours["incore"]).max() <= 1e-10  # Eh/Bohr


@pytest.mark.parametrize("mode", MODES)
def test_uhf_gradient_matches_jax(hydroxyl, mode):
    port, ref = hydroxyl
    cfg = HartreeFockConfig(epsilon=1e-12, max_iterations=400, spin_multiplicity=2,
                            fock_mode=mode)
    g = uhf_gradient(port, cfg, device="cpu")
    assert np.abs(g - ref).max() <= 1e-8  # Eh/Bohr
    assert np.abs(g.sum(axis=0)).max() <= 1e-9


def test_spherical_gradient_matches_finite_difference():
    """Water/cc-pVDZ in 5d: the x component of H1 against the central
    difference of the port's own total energy at h = 1e-3 Bohr (its error,
    of order h^2 times the third derivative, is far below 1e-6)."""
    port, _ = _systems("water", "cc-pVDZ", spherical=True)
    cfg = HartreeFockConfig(epsilon=1e-11, max_iterations=200)
    out = restricted_hartree_fock(port, cfg, device="cpu")
    g = rhf_gradient(port, cfg, output=out, device="cpu")
    h = 1e-3
    energies = []
    for sign in (1.0, -1.0):
        x = port.positions.copy()
        x[1, 0] += sign * h
        run = restricted_hartree_fock(port.with_positions(x), cfg, density_guess=out.density,
                                      device="cpu")
        energies.append(run.total_energy())
    fd = (energies[0] - energies[1]) / (2.0 * h)
    assert abs(g[1, 0] - fd) <= 1e-6  # Eh/Bohr
    assert np.abs(g.sum(axis=0)).max() <= 1e-9


def test_translation_invariance(water_sto3g):
    """The gradient does not move when the molecule does, and sums to 0
    over the atoms."""
    port, ref = water_sto3g
    cfg = HartreeFockConfig(epsilon=1e-11, max_iterations=200)
    g = rhf_gradient(port, cfg, device="cpu")
    moved = rhf_gradient(port.with_positions(port.positions + np.array([0.3, -0.7, 1.1])), cfg,
                         device="cpu")
    assert np.abs(moved - g).max() <= 1e-9  # Eh/Bohr
    assert np.abs(g.sum(axis=0)).max() <= 1e-9


def test_field_raises():
    port, _ = _systems("water", "STO-3G")
    cfg = HartreeFockConfig(epsilon=1e-10, electric_field=(0.0, 0.0, 1e-3))
    for fn in (rhf_gradient, uhf_gradient, rhf_gradient_pair):
        with pytest.raises(NotImplementedError):
            fn(port, cfg, device="cpu")


def test_unconverged_scf_raises():
    port, _ = _systems("water", "STO-3G")
    cfg = HartreeFockConfig(epsilon=1e-14, max_iterations=2)
    out = restricted_hartree_fock(port, cfg, device="cpu")
    assert not out.converged
    with pytest.raises(RuntimeError, match="not converged"):
        rhf_gradient(port, cfg, output=out, device="cpu")
    oh, _ = _systems("hydroxyl", "STO-3G")
    ucfg = dataclasses.replace(cfg, spin_multiplicity=2)
    uout = unrestricted_hartree_fock(oh, ucfg, device="cpu")
    with pytest.raises(RuntimeError, match="not converged"):
        uhf_gradient(oh, ucfg, output=uout, device="cpu")
    with pytest.raises(RuntimeError, match="did not converge"):
        scf_and_gradient(port, cfg, device="cpu")


def test_scf_and_gradient_picks_the_method(hydroxyl):
    port, ref = hydroxyl
    cfg = HartreeFockConfig(epsilon=1e-12, max_iterations=400, spin_multiplicity=2)
    assert is_open_shell(port, cfg)
    out, g = scf_and_gradient(port, cfg, device="cpu")
    assert out.density.shape[0] == 2 and np.abs(g - ref).max() <= 1e-8


def _full_table_r(L, p, PCx, PCy, PCz):
    """The R recursion over the whole table at every level (the form the
    level-order recursion replaced), the reference for both tests below."""
    T = p * (PCx * PCx + PCy * PCy + PCz * PCz)
    F = mcmurchie.boys(L, T)
    base, acc = [], torch.ones_like(p)
    for n in range(L + 1):
        base.append(acc * F[n])
        acc = acc * (-2.0 * p)
    bshape = torch.broadcast_shapes(p.shape, PCx.shape, PCy.shape, PCz.shape)
    if L == 0:
        return base[0].expand(bshape)[None]
    onehot, idx1, idx2, coef = mcmurchie._r_plan(L)
    H = len(onehot)
    extra = (1,) * len(bshape)
    o = [torch.as_tensor(onehot[:, d], dtype=p.dtype).reshape((H,) + extra) for d in range(3)]
    PCs = o[0] * PCx[None] + o[1] * PCy[None] + o[2] * PCz[None]
    c = torch.as_tensor(coef, dtype=p.dtype).reshape((H,) + extra)
    i1, i2 = torch.as_tensor(idx1, dtype=torch.long), torch.as_tensor(idx2, dtype=torch.long)
    R = torch.zeros((H,) + tuple(bshape), dtype=p.dtype)
    R[0] = base[L]
    for n in range(L - 1, -1, -1):
        R = PCs * R[i1] + c * R[i2]
        R[0] = base[n]
    return R


def _r_inputs(seed):
    g = torch.Generator().manual_seed(seed)
    p = torch.rand(5, 1, 4, generator=g, dtype=torch.float64) * 3.0 + 0.1
    PC = [torch.randn(5, 3, 4, generator=g, dtype=torch.float64) for _ in range(3)]
    PC[1][0] = 0.0  # points on an axis and at the centre: T = 0 exactly
    PC[0][1], PC[2][1] = 0.0, -0.0
    return p, PC


@pytest.mark.parametrize("L", [0, 1, 2, 4, 8, 12])
def test_level_order_r_table_equals_the_full_recursion(L):
    p, PC = _r_inputs(L)
    ours = mcmurchie.r_table_components(L, p, *PC)
    ref = _full_table_r(L, p, *PC)
    assert torch.equal(ours.view(torch.int64), ref.view(torch.int64))  # equal bits


@pytest.mark.parametrize("L", [1, 3, 6])
def test_r_table_backward_matches_autograd_of_the_recursion(L):
    """d/dPC of sum(W * R) by the table at L + 1 against autograd through
    the recursion and the Boys function, within 1e-11 relative."""
    p, PC = _r_inputs(10 + L)
    W = torch.randn((mcmurchie.nhermite(L),) + PC[0].shape, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(L))
    grads = []
    for fn in (mcmurchie.r_table_components, _full_table_r):
        leaves = [t.clone().requires_grad_() for t in PC]
        grads.append(torch.autograd.grad((fn(L, p, *leaves) * W).sum(), leaves))
    for ours, ref in zip(*grads):
        assert (ours - ref).abs().max() <= 1e-11 * ref.abs().max()


def test_padded_at_reproduces_the_engine_operands():
    port, _ = _systems("water", "6-31G")
    eng = TiledEriEngine(port, 1e-12, device="cpu")
    pos = torch.as_tensor(port.positions, dtype=torch.float64).requires_grad_()
    rebuilt = eng.padded_at(pos)
    assert len(rebuilt) == len(eng._padded)
    for ours, ref in zip(rebuilt, eng._padded):
        for a, b in zip(ours, ref):
            assert torch.equal(a.detach(), b)
    assert rebuilt[0][2].requires_grad  # P follows the positions
