"""Port parity, one-electron layer: the Boys function and S, T, V of
``qchem_rs_tpu_torch`` against the JAX package on the CPU, same inputs."""

import os

import numpy as np
import pytest
import torch

from qchem_rs_tpu.ops import boys as jax_boys
from qchem_rs_tpu.ops import one_electron as jax_one
from qchem_rs_tpu.utils.basis import BasisSet as JaxBasisSet
from qchem_rs_tpu.utils.system import MolecularSystem as JaxSystem
from qchem_rs_tpu_torch.ops import boys as port_boys
from qchem_rs_tpu_torch.ops import one_electron as port_one
from qchem_rs_tpu_torch.utils.basis import BasisSet
from qchem_rs_tpu_torch.utils.interop import system_from_numpy

DATA = os.path.join(os.path.dirname(__file__), "..", "data")


@pytest.mark.parametrize("order", range(9))
def test_boys_matches_jax(order):
    # the three branches: Taylor F0 (T < 0.01), Kummer + downward
    # (T <= order + 1.5) and upward recursion, plus their borders
    rng = np.random.default_rng(order)
    T = np.concatenate([
        np.linspace(0.0, 60.0, 601),
        np.geomspace(1e-14, 0.02, 40),
        rng.uniform(0.0, 60.0, 200),
        [order + 1.5, order + 1.5 + 1e-12, 0.01],
    ])
    ref = np.asarray(jax_boys.boys(order, T))
    out = port_boys.boys(order, torch.tensor(T)).numpy()
    assert out.shape == ref.shape == (order + 1, T.size)
    assert np.max(np.abs(out - ref) / np.abs(ref)) <= 1e-13


@pytest.fixture(scope="module")
def water_ccpvdz():
    """(JAX system, port system) for water/cc-pVDZ, the port's built from
    the JAX system's numpy arrays."""
    jax_sys = JaxSystem.load(
        os.path.join(DATA, "mol", "water.json"),
        JaxBasisSet.load(os.path.join(DATA, "basis", "cc-pVDZ.json")),
    )
    port_sys = system_from_numpy(
        jax_sys.charges.astype(int), jax_sys.positions,
        BasisSet.load(os.path.join(DATA, "basis", "cc-pVDZ.json")),
    )
    return jax_sys, port_sys


@pytest.mark.parametrize("name", ["overlap", "kinetic", "nuclear"])
def test_one_electron_matches_jax(water_ccpvdz, name):
    jax_sys, port_sys = water_ccpvdz
    ref = np.asarray(getattr(jax_one, name)(jax_sys))
    out = getattr(port_one, name)(port_sys, "cpu").numpy()
    assert out.shape == ref.shape == (25, 25)
    assert np.max(np.abs(out - ref)) <= 1e-12
