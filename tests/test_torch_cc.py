"""Port parity, CCSD and CCSD(T): the port's amplitude steps and (T)
energies against the JAX package's on seeded numpy inputs (1e-12
relative), and ``ccsd`` end to end on H2/6-31G, water/STO-3G and OH/STO-3G
against the JAX package's ``ccsd`` on the same converged orbitals (the
port's SCF output, passed to both as ``output=``): energies within
1e-10 Eh. Also the anchors of the JAX package's own tests: CCSD equals
FCI on a two-electron system, and lies inside the FCI envelope on
water/STO-3G with (T) moving toward it."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qchem_rs_tpu import HartreeFockConfig as JaxConfig
from qchem_rs_tpu.models import cc as jax_cc
from qchem_rs_tpu.utils.basis import BasisSet as JaxBasisSet
from qchem_rs_tpu.utils.system import MolecularSystem as JaxSystem
from qchem_rs_tpu_torch import (BasisSet, HartreeFockConfig, MolecularSystem,
                                restricted_hartree_fock, unrestricted_hartree_fock)
from qchem_rs_tpu_torch.models import cc, fci, mp2
from tests.torch_threads import one_torch_thread  # noqa: F401

DATA = os.path.join(os.path.dirname(__file__), "..", "data")
STEP_RTOL = 1e-12  # steps on seeded inputs, relative to the largest element
ENERGY_TOL = 1e-10  # Eh


def _systems(mol, basis):
    mpath = os.path.join(DATA, "mol", f"{mol}.json")
    bpath = os.path.join(DATA, "basis", f"{basis}.json")
    return (MolecularSystem.load(mpath, BasisSet.load(bpath)),
            JaxSystem.load(mpath, JaxBasisSet.load(bpath)))


def _rel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(a)), 1e-300))


def _t(x):
    return torch.as_tensor(np.asarray(x))


@pytest.fixture(scope="module")
def spinorbital_inputs():
    rng = np.random.default_rng(7)
    no, nv = 4, 6
    n = no + nv
    W = rng.standard_normal((n, n, n, n)) * 0.1
    W = W - W.transpose(1, 0, 2, 3)
    W = W - W.transpose(0, 1, 3, 2)
    t1 = rng.standard_normal((no, nv)) * 0.05
    t2 = rng.standard_normal((no, no, nv, nv)) * 0.05
    eo, ev = -1.0 - rng.random(no), 0.5 + rng.random(nv)
    f = tuple(rng.standard_normal(s) * 0.1 for s in [(no, no), (no, nv), (nv, nv)])
    return no, W, t1, t2, eo, ev, f


@pytest.mark.parametrize("with_f", [False, True])
def test_ccsd_step_matches_jax(spinorbital_inputs, with_f):
    no, W, t1, t2, eo, ev, f = spinorbital_inputs
    ref = jax_cc._ccsd_step(jnp.asarray(t1), jnp.asarray(t2), jnp.asarray(eo), jnp.asarray(ev),
                            no, jnp.asarray(W), tuple(map(jnp.asarray, f)) if with_f else None)
    out = cc._ccsd_step(_t(t1), _t(t2), _t(eo), _t(ev), no, _t(W),
                        tuple(map(_t, f)) if with_f else None)
    for a, b in zip(ref, out):
        assert _rel(a, b) <= STEP_RTOL


def test_triples_energy_matches_jax(spinorbital_inputs):
    no, W, t1, t2, eo, ev, _ = spinorbital_inputs
    ref = float(jax_cc._triples_energy(jnp.asarray(t1), jnp.asarray(t2), jnp.asarray(eo),
                                       jnp.asarray(ev), no, jnp.asarray(W)))
    out = float(cc._triples_energy(_t(t1), _t(t2), _t(eo), _t(ev), no, _t(W)))
    assert abs(out - ref) <= STEP_RTOL * abs(ref)


@pytest.fixture(scope="module")
def spatial_inputs():
    """Seeded closed-shell inputs: a chemist-symmetric e4 over 8 orbitals,
    orthonormal C, amplitudes with T's (ij)(ab) symmetry, and the
    physicist blocks of both packages."""
    rng = np.random.default_rng(11)
    no, nv = 3, 5
    n = no + nv
    e = rng.standard_normal((n,) * 4)
    e = e + e.transpose(1, 0, 2, 3)
    e = e + e.transpose(0, 1, 3, 2)
    e = 0.05 * (e + e.transpose(2, 3, 0, 1))
    C = np.linalg.qr(rng.standard_normal((n, n)))[0]
    t1 = rng.standard_normal((no, nv)) * 0.05
    T = rng.standard_normal((no, no, nv, nv)) * 0.05
    T = T + T.transpose(1, 0, 3, 2)
    eo, ev = -1.0 - rng.random(no), 0.5 + rng.random(nv)
    g_ref = jax_cc._mo_phys_blocks(jnp.asarray(e), jnp.asarray(C[:, :no]), jnp.asarray(C[:, no:]))
    g = cc._mo_phys_blocks(_t(e), _t(C[:, :no]), _t(C[:, no:]))
    return t1, T, eo, ev, g_ref, g


def test_mo_phys_blocks_match_jax(spatial_inputs):
    *_, g_ref, g = spatial_inputs
    assert set(g) == set(g_ref)
    for k in g_ref:
        assert _rel(g_ref[k], g[k]) <= STEP_RTOL, k


def test_phys_from_chem_matches_jax():
    rng = np.random.default_rng(3)
    no, nv = 2, 3
    shapes = [(no,) * 4, (no, no, no, nv), (no, no, nv, nv), (no, nv, no, nv), (no, nv, nv, nv),
              (nv,) * 4]
    blocks = [rng.standard_normal(s) for s in shapes]
    ref = jax_cc._phys_from_chem(*map(jnp.asarray, blocks))
    out = cc._phys_from_chem(*map(_t, blocks))
    for k in ref:
        assert np.array_equal(np.asarray(ref[k]), out[k].numpy()), k
        assert out[k].is_contiguous()


def test_ccsd_rhf_step_matches_jax(spatial_inputs):
    t1, T, eo, ev, g_ref, g = spatial_inputs
    ref = jax_cc._ccsd_rhf_step(jnp.asarray(t1), jnp.asarray(T), jnp.asarray(eo), jnp.asarray(ev),
                                g_ref)
    out = cc._ccsd_rhf_step(_t(t1), _t(T), _t(eo), _t(ev), g)
    for a, b in zip(ref, out):
        assert _rel(a, b) <= STEP_RTOL


def test_rhf_triples_match_jax_and_batched_matches_full(spatial_inputs):
    t1, T, eo, ev, g_ref, g = spatial_inputs
    ref = float(jax_cc._triples_energy_rhf(jnp.asarray(t1), jnp.asarray(T), jnp.asarray(eo),
                                           jnp.asarray(ev), g_ref))
    full = float(cc._triples_energy_rhf(_t(t1), _t(T), _t(eo), _t(ev), g))
    batched = float(cc._triples_energy_rhf_batched(_t(t1), _t(T), _t(eo), _t(ev), g))
    assert abs(full - ref) <= STEP_RTOL * abs(ref)
    assert abs(batched - full) <= STEP_RTOL * abs(full)


def test_amplitude_diis_keeps_its_history_on_the_amplitudes_device():
    rng = np.random.default_rng(5)
    diis = cc._AmplitudeDiis(max_vectors=3)
    amps = [torch.as_tensor(rng.standard_normal(6)) for _ in range(5)]
    errs = [torch.as_tensor(rng.standard_normal(6)) for _ in range(5)]
    for a, e in zip(amps, errs):
        mixed = diis.extrapolate(a, e)
    assert len(diis.errs) == 3 and mixed.device == amps[0].device
    # the host-side DIIS of the JAX package on the same history
    ref = jax_cc._AmplitudeDiis(max_vectors=3)
    for a, e in zip(amps, errs):
        ref_mixed = ref.extrapolate(a.numpy(), e.numpy())
    assert _rel(ref_mixed, mixed) <= STEP_RTOL


CFG = dict(epsilon=1e-10, max_iterations=100)  # the JAX CLI's and tests' SCF


@pytest.fixture(scope="module")
def water():
    """Water/STO-3G: the port's RHF and the JAX package's CCSD(T) on it,
    spatial (frozen 0 and "auto") and spinorbital."""
    port, jsys = _systems("water", "STO-3G")
    out = restricted_hartree_fock(port, HartreeFockConfig(**CFG), device="cpu")
    ref = {}
    for key, kw in {"spatial": dict(formulation="spatial"),
                    "spinorbital": dict(formulation="spinorbital"),
                    "frozen auto": dict(frozen="auto")}.items():
        ref[key] = jax_cc.ccsd(jsys, JaxConfig(**CFG), triples=True, cc_epsilon=1e-10,
                               output=out, **kw)
    return port, out, ref


@pytest.mark.parametrize("case", ["spatial", "spinorbital", "frozen auto", "pair"])
def test_water_ccsd_t_matches_jax(water, case):
    port, out, ref = water
    kw = {"spatial": dict(formulation="spatial"), "spinorbital": dict(formulation="spinorbital"),
          "frozen auto": dict(frozen="auto"), "pair": {}}[case]
    cfg = HartreeFockConfig(**CFG, fock_mode="pair" if case == "pair" else "incore")
    res = cc.ccsd(port, cfg, triples=True, cc_epsilon=1e-10, output=out, device="cpu", **kw)
    want = ref["spatial" if case == "pair" else case]
    assert res.converged and res.scf_iterations == out.iterations
    assert abs(res.correlation_energy - want.correlation_energy) <= ENERGY_TOL
    assert abs(res.mp2_correlation_energy - want.mp2_correlation_energy) <= ENERGY_TOL
    assert abs(res.triples_correction - want.triples_correction) <= ENERGY_TOL
    assert abs(res.total_energy() - want.total_energy()) <= ENERGY_TOL
    assert set(res.timings) == {"eri_s", "blocks_s", "cc_s", "triples_s", "total_s"}


def test_water_ccsd_inside_the_fci_envelope(water):
    port, out, ref = water
    cc_t = ref["spatial"]
    res = cc.ccsd(port, HartreeFockConfig(**CFG), triples=True, cc_epsilon=1e-10, output=out,
                  device="cpu")
    e_fci = fci.fci(port, HartreeFockConfig(**CFG), device="cpu").total_energy()
    m = mp2.mp2(port, output=out, device="cpu")
    assert abs(res.mp2_correlation_energy - m.correlation_energy) <= ENERGY_TOL
    e_ccsd = res.scf_total_energy + res.correlation_energy
    assert abs(e_ccsd - e_fci) < 3e-3 and abs(e_ccsd - e_fci) < abs(m.total_energy() - e_fci)
    assert abs(res.total_energy() - e_fci) < abs(e_ccsd - e_fci)
    assert abs(res.total_energy() - cc_t.total_energy()) <= ENERGY_TOL


def test_h2_ccsd_equals_fci_and_jax():
    port, jsys = _systems("hydrogen", "6-31G")
    cfg = dict(epsilon=1e-10, max_iterations=100)
    out = restricted_hartree_fock(port, HartreeFockConfig(**cfg), device="cpu")
    res = cc.ccsd(port, HartreeFockConfig(**cfg), triples=True, cc_epsilon=1e-10, output=out,
                  device="cpu")
    ref = jax_cc.ccsd(jsys, JaxConfig(**cfg), triples=True, cc_epsilon=1e-10, output=out)
    e_fci = fci.fci(port, HartreeFockConfig(**cfg), device="cpu").total_energy()
    assert res.converged
    assert abs(res.correlation_energy - ref.correlation_energy) <= ENERGY_TOL
    assert abs(res.scf_total_energy + res.correlation_energy - e_fci) <= 1e-9
    assert abs(res.triples_correction) <= 1e-12  # no triples in a two-electron system


def test_oh_uccsd_t_matches_jax():
    """UCCSD(T) on the OH doublet through the spinorbital path, on the
    port's UHF at 1e-12 (its diag_rms stop is rounding-decided at 1e-10)."""
    port, jsys = _systems("hydroxyl", "STO-3G")
    cfg = dict(epsilon=1e-12, max_iterations=300, spin_multiplicity=2)
    out = unrestricted_hartree_fock(port, HartreeFockConfig(**cfg), device="cpu")
    assert out.converged
    res = cc.ccsd(port, HartreeFockConfig(**cfg), triples=True, cc_epsilon=1e-10, output=out,
                  device="cpu")
    ref = jax_cc.ccsd(jsys, JaxConfig(**cfg), triples=True, cc_epsilon=1e-10, output=out)
    assert res.converged and res.correlation_energy < res.mp2_correlation_energy < 0.0
    assert abs(res.correlation_energy - ref.correlation_energy) <= ENERGY_TOL
    assert abs(res.triples_correction - ref.triples_correction) <= ENERGY_TOL


def test_ccsd_guards():
    port, _ = _systems("hydroxyl", "STO-3G")
    with pytest.raises(ValueError, match="closed shell"):
        cc.ccsd(port, HartreeFockConfig(spin_multiplicity=2, max_iterations=300),
                formulation="spatial", device="cpu")
    water, _ = _systems("water", "STO-3G")
    out = restricted_hartree_fock(water, HartreeFockConfig(epsilon=1e-8), device="cpu")
    with pytest.raises(ValueError, match="unknown formulation"):
        cc.ccsd(water, formulation="bogus", output=out, device="cpu")
    with pytest.raises(ValueError, match="no correlated"):
        cc.ccsd(water, frozen=5, output=out, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cc.ccsd(water, output=out)
