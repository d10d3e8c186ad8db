"""Boys function F_0..F_mmax(T), float64, on tensors of any device.

The algorithm of ``qchem_rs_tpu/ops/boys.py::boys`` in PyTorch:

- ``F_0(T) = 1/2 sqrt(pi/T) erf(sqrt T)`` (a 7-term Taylor series below
  T = 0.01, where the closed form loses digits);
- m >= 1, T > mmax + 1.5: upward recursion from F_0 (contracting there);
- m >= 1, T <= mmax + 1.5: Kummer series at m = mmax with 2 mmax + 40
  terms, then exact downward recursion (always stable), which also gives
  F_0 in that range.

The CUDA tile kernel (``csrc/eri_tile.cu``, device function ``boys``) runs
the same three branches per point.
"""

from __future__ import annotations

import math

import torch

_F0_TAYLOR = [1.0 / (math.factorial(k) * (2 * k + 1)) for k in range(7)]


def series_terms(mmax: int) -> int:
    """Length of the Kummer series; bounds the relative tail under ~1e-17
    for every order used here (the JAX package validates it against a
    quadrature oracle)."""
    return 2 * mmax + 40


def boys(mmax: int, T: torch.Tensor) -> torch.Tensor:
    """F_0..F_mmax at T (elementwise), shape (mmax+1,) + T.shape."""
    Tc = torch.clamp(T, min=1e-30)
    F0 = 0.5 * torch.sqrt(math.pi / Tc) * torch.erf(torch.sqrt(Tc))
    f0_taylor = torch.full_like(T, _F0_TAYLOR[6])
    for k in range(5, -1, -1):
        f0_taylor = _F0_TAYLOR[k] - T * f0_taylor
    F0 = torch.where(T < 0.01, f0_taylor, F0)
    if mmax == 0:
        return F0[None]

    switch = mmax + 1.5
    expT = torch.exp(-T)

    # upward branch (evaluated everywhere, selected where T > switch)
    Tbig = torch.clamp(T, min=switch)
    fs_big = [F0]
    for m in range(mmax):
        fs_big.append(((2.0 * m + 1.0) * fs_big[-1] - expT) / (2.0 * Tbig))

    # series at mmax + downward recursion (selected where T <= switch)
    Tsm = torch.clamp(T, max=switch)
    term = torch.full_like(T, 1.0 / (2.0 * mmax + 1.0))
    ssum = term.clone()
    for i in range(series_terms(mmax)):
        term = term * (2.0 * Tsm) / (2.0 * mmax + 2.0 * i + 3.0)
        ssum = ssum + term
    fs_small = [expT * ssum]
    for m in range(mmax, 0, -1):
        fs_small.append((2.0 * Tsm * fs_small[-1] + expT) / (2.0 * m - 1.0))
    fs_small = fs_small[::-1]  # F_0 .. F_mmax

    use_small = T <= switch
    return torch.stack(
        [torch.where(use_small, s, b) for s, b in zip(fs_small, fs_big)], dim=0
    )
