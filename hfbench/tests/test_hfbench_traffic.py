"""The geometry streams: the same seed gives the same bits, every normal
mode is displaced with its classical variance, and the harmonic modes
derived with symmetry agree with the port's full Hessian."""

import json

import numpy as np
import pytest

from hfbench import derive_modes, stream
from hfbench.tests.conftest import ROOT

WATER = json.loads((ROOT / "hfbench/tests/data/water-sto3g-direct.json").read_text())


def _mix(**kw):
    return json.loads((ROOT / "hfbench/traffic/md17.json").read_text()) | kw


def _modes():
    return json.loads((ROOT / WATER["modes"]).read_text())


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 11, 2**40 + 3])
def test_repeats_bit_for_bit(seed):
    a = stream.GeometryStream(_mix(), _modes(), seed, stream.WINDOW).next()
    g1, g2 = (stream.GeometryStream.of(_mix(), WATER, ROOT, seed, stream.WINDOW) for _ in range(2))
    for _ in range(5):
        assert np.array_equal(g1.next(), g2.next())
    other = stream.GeometryStream(_mix(), _modes(), seed + 1, stream.WINDOW).next()
    assert not np.array_equal(a, other)
    assert not np.array_equal(a, stream.GeometryStream(_mix(), _modes(), seed, stream.WARMUP).next())


@pytest.mark.parametrize("temperature", [500.0, 100.0])
def test_classical_variance_of_each_mode(temperature):
    """q_k = L_k^T M^(1/2) u has variance kT / w_k^2 (atomic units)."""
    modes = _modes()
    g = stream.GeometryStream(_mix(rotate=False, pool=0, temperature_K=temperature), modes, 3, stream.WINDOW)
    x0 = np.asarray(modes["positions"])
    u = np.array([(g.next() - x0).reshape(-1) for _ in range(20000)])
    sm = np.sqrt(np.repeat(np.asarray(modes["masses_amu"]) * stream.AMU_TO_ME, 3))
    q = (u * sm) @ np.asarray(modes["modes"])
    w = np.asarray(modes["frequencies_cm1"]) / stream.AU_TO_CM1
    want = stream.KB_HARTREE_PER_K * temperature / w**2
    assert np.allclose(q.var(axis=0), want, rtol=0.03)
    # no rigid motion: the displacements keep the centre of mass and add no rotation
    m = np.asarray(modes["masses_amu"])
    assert np.abs((u.reshape(len(u), -1, 3) * m[None, :, None]).sum(axis=1)).max() < 1e-12


def test_rotation_keeps_shape():
    g1 = stream.GeometryStream(_mix(rotate=True), _modes(), 9, stream.WINDOW)
    g2 = stream.GeometryStream(_mix(rotate=False), _modes(), 9, stream.WINDOW)
    a, b = g1.next(), g2.next()
    d = lambda x: np.linalg.norm(x[:, None] - x[None], axis=-1)  # noqa: E731
    assert np.allclose(d(a), d(b), atol=1e-12) and not np.allclose(a, b)
    R = stream.rotation(np.random.default_rng(1))
    assert np.allclose(R @ R.T, np.eye(3), atol=1e-14) and np.isclose(np.linalg.det(R), 1.0)


def test_pool_is_one_set_in_another_order():
    mix = _mix(rotate=False)
    sets = []
    for seed in (1, 2, 2**33):
        g = stream.GeometryStream(mix, _modes(), seed, stream.WINDOW)
        first = [g.next() for _ in range(mix["pool"])]
        sets.append(sorted(x.tobytes() for x in first))
        assert len(set(sets[-1])) == mix["pool"]
        again = g.next()
        assert any(np.array_equal(again, x) for x in first)  # the next cycle reuses the set
    assert sets[0] == sets[1] == sets[2]
    orders = [stream.GeometryStream(mix, _modes(), s, stream.WINDOW).next().tobytes() for s in (1, 2)]
    assert orders[0] != orders[1]


@pytest.mark.parametrize("config", ["hfbench/configs/naphthalene-ccpvdz-direct.json",
                                    "hfbench/configs/naphthalene-ccpvdz-incore.json",
                                    "hfbench/tests/data/water-sto3g-direct.json"])
def test_modes_belong_to_the_configuration(config):
    """The modes file is about the configuration's own molecule file, at
    its level, and the geometry there is a minimum with the start's
    symmetry."""
    from hfbench.reference.molecule import read_molecule

    c = json.loads((ROOT / config).read_text())
    modes = json.loads((ROOT / c["modes"]).read_text())
    numbers, x0 = read_molecule(ROOT / c["molecule"])
    assert modes["numbers"] == numbers.tolist() and np.array_equal(np.asarray(modes["positions"]), x0)
    assert all(modes["level"][k] == c[k] for k in ("basis", "spherical", "charge", "screening_threshold"))
    n = len(numbers)
    L = np.asarray(modes["modes"])
    assert L.shape == (3 * n, 3 * n - 6) and np.allclose(L.T @ L, np.eye(3 * n - 6), atol=1e-10)
    assert min(modes["frequencies_cm1"]) > 0 and modes["max_gradient_at_minimum"] < 1e-3
    _, start = read_molecule(ROOT / modes["start"])
    assert len(derive_modes.point_group(numbers, x0)) == len(derive_modes.point_group(numbers, start))


def test_symmetric_hessian_matches_the_ports():
    """The forward-difference Hessian over the symmetry-unique atoms gives
    the frequencies of the port's central-difference Hessian over every
    atom, at the committed water minimum."""
    from qchem_rs_tpu_torch.config import HartreeFockConfig
    from qchem_rs_tpu_torch.models.gradients import scf_and_gradient
    from qchem_rs_tpu_torch.models.hessian import harmonic_frequencies
    from qchem_rs_tpu_torch.utils.basis import BasisSet
    from qchem_rs_tpu_torch.utils.system import MolecularSystem

    system = MolecularSystem.load(ROOT / WATER["molecule"], BasisSet.load(ROOT / WATER["basis"]))
    settings = HartreeFockConfig(epsilon=derive_modes.EPSILON, max_iterations=300, initial_guess="sad")
    numbers = np.array([a.ordinal for a in system.atoms])
    x0 = np.asarray(system.positions)
    ops = derive_modes.point_group(numbers, x0)
    assert len(ops) == 4  # C2v
    calls = []

    def gradient(x):
        calls.append(x)
        return np.asarray(scf_and_gradient(system.with_positions(x), settings, device="cpu")[1]).reshape(x.shape)

    H, _ = derive_modes.hessian(gradient, x0, ops, log=lambda s: None)
    assert len(calls) == 1 + 6  # g0, then O and one H, three axes each
    _, freqs, _ = derive_modes.normal_modes(numbers, x0, H)
    full = harmonic_frequencies(system, settings, device="cpu").frequencies_cm1[6:]
    assert np.allclose(freqs, full, rtol=5e-3)
    assert np.allclose(freqs, _modes()["frequencies_cm1"], rtol=1e-6)
