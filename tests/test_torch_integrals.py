"""Port parity, one-electron layer: the Boys function and S, T, V of
``qchem_rs_tpu_torch`` against the JAX package on the CPU, same inputs."""

import math
import os
from fractions import Fraction

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
from tests.torch_threads import one_torch_thread  # noqa: F401

DATA = os.path.join(os.path.dirname(__file__), "..", "data")


def kummer_coefficients(mmax: int) -> list[float]:
    """c_i = prod_{k=0..i} 1/(2 mmax + 2k + 1), i = 0..series_terms(mmax):
    the Kummer series at mmax as a polynomial in 2T, the products the CUDA
    kernel builds at compile time (``KummerCoef``)."""
    coefs, c = [], 1.0
    for k in range(port_boys.series_terms(mmax) + 1):
        c *= 1.0 / (2 * mmax + 2 * k + 1)
        coefs.append(c)
    return coefs


def boys_reciprocal(mmax: int, T: torch.Tensor, rsqrt: bool = False) -> torch.Tensor:
    """F_0..F_mmax at T in the CUDA kernel's arithmetic, shape
    (mmax+1,) + T.shape: the branches of ``boys`` with every division in a
    loop replaced by a product with a constant reciprocal (the series by
    Horner's rule on ``kummer_coefficients``), and one 1/T per point; with
    ``rsqrt`` (``boys<M, true>``, kernel 3) sqrt(T) and 1/T from one
    1/sqrt(T)."""
    Tc = torch.clamp(T, min=1e-30)
    if rsqrt:
        rT = torch.rsqrt(Tc)
        invT = rT * rT
        F0 = (0.5 * math.sqrt(math.pi)) * rT * torch.erf(Tc * rT)
    else:
        invT = 1.0 / Tc
        F0 = 0.5 * torch.sqrt(math.pi * invT) * torch.erf(torch.sqrt(Tc))
    if mmax == 0:
        taylor = [1.0 / (math.factorial(k) * (2 * k + 1)) for k in range(7)]
        f0_taylor = torch.full_like(T, taylor[6])
        for k in range(5, -1, -1):
            f0_taylor = taylor[k] - T * f0_taylor
        return torch.where(T < 0.01, f0_taylor, F0)[None]
    expT = torch.exp(-T)
    fs_big = [F0]
    for m in range(mmax):
        fs_big.append(((2.0 * m + 1.0) * fs_big[-1] - expT) * (0.5 * invT))
    x = 2.0 * T
    coefs = kummer_coefficients(mmax)
    poly = torch.full_like(T, coefs[-1])
    for c in reversed(coefs[:-1]):
        poly = poly * x + c
    fs_small = [expT * poly]
    for m in range(mmax, 0, -1):
        fs_small.append((x * fs_small[-1] + expT) * (1.0 / (2 * m - 1)))
    fs_small = fs_small[::-1]
    use_small = T <= mmax + 1.5
    return torch.stack([torch.where(use_small, s, b) for s, b in zip(fs_small, fs_big)], dim=0)


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


@pytest.mark.parametrize("order", range(9))
def test_boys_reciprocal_matches_boys(order):
    # the CUDA kernel's division-free Boys arithmetic against the port's
    # boys over T in [0, 50], m <= 8
    T = torch.cat([torch.linspace(0.0, 50.0, 5001, dtype=torch.float64),
                   torch.tensor([0.0, 1e-12, 0.0099999, 0.01, order + 1.5], dtype=torch.float64)])
    ref = port_boys.boys(order, T)
    out = boys_reciprocal(order, T)
    assert out.shape == ref.shape == (order + 1, T.numel())
    assert float(((out - ref).abs() / ref.abs()).max()) <= 1e-14


@pytest.mark.parametrize("order", range(9))
def test_boys_rsqrt_form_matches_boys(order):
    # kernel 3's form of the closed-form branch (boys<M, true>): sqrt(T) and
    # 1/T from one reciprocal square root
    T = torch.cat([torch.linspace(0.0, 50.0, 5001, dtype=torch.float64),
                   torch.tensor([0.0, 1e-12, 0.0099999, 0.01, order + 1.5], dtype=torch.float64)])
    ref = port_boys.boys(order, T)
    out = boys_reciprocal(order, T, rsqrt=True)
    assert float(((out - ref).abs() / ref.abs()).max()) <= 1e-14


@pytest.mark.parametrize("order", range(9))
def test_kummer_coefficients_are_the_series_products(order):
    # the constants of the kernel's Horner series: c_k = prod_{i<=k}
    # 1/(2 order + 2i + 1), within two roundings per factor of the exact
    # product (and one for its conversion to float)
    coefs = kummer_coefficients(order)
    assert len(coefs) == port_boys.series_terms(order) + 1
    exact = Fraction(1)
    for k, c in enumerate(coefs):
        exact /= 2 * order + 2 * k + 1
        assert abs(c - float(exact)) <= (k + 2) * 2.3e-16 * float(exact)


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


@pytest.mark.parametrize("name", ["overlap", "kinetic", "nuclear"])
def test_spherical_one_electron_matches_jax(water_ccpvdz, name):
    # the same water/cc-pVDZ in spherical AOs (24): the JAX package projects
    # its Cartesian matrices as sph_T^T X sph_T, with the class programs the
    # Cartesian test compiled
    jax_sys, port_sys = water_ccpvdz
    jax_sph = JaxSystem(jax_sys.atoms, jax_sys.basis, spherical=True)
    port_sph = system_from_numpy(port_sys.charges.astype(int), port_sys.positions, port_sys.basis,
                                 spherical=True)
    ref = np.asarray(getattr(jax_one, name)(jax_sph))
    out = getattr(port_one, name)(port_sph, "cpu").numpy()
    assert out.shape == ref.shape == (24, 24)
    assert np.max(np.abs(out - ref)) <= 1e-12
