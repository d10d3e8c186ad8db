"""Cartesian angular-momentum bookkeeping shared by all integral classes
(copy of ``qchem_rs_tpu/ops/angular.py``).

Cartesian Gaussians x^i y^j z^k exp(-a r^2) with i+j+k = l, enumerated in
CCA order: lx descending, then ly descending. Supports l <= 4.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np


def ncart(l: int) -> int:
    """Number of Cartesian components for angular momentum l."""
    return (l + 1) * (l + 2) // 2


@lru_cache(maxsize=None)
def cart_components(l: int) -> tuple[tuple[int, int, int], ...]:
    """Cartesian power triples (lx, ly, lz) with lx+ly+lz == l, CCA order."""
    return tuple(
        (lx, ly, l - lx - ly)
        for lx in range(l, -1, -1)
        for ly in range(l - lx, -1, -1)
    )


def double_factorial(n: int) -> int:
    """(n)!! with (-1)!! == (0)!! == 1."""
    out = 1
    while n > 1:
        out *= n
        n -= 2
    return out


@lru_cache(maxsize=None)
def component_norms(l: int) -> np.ndarray:
    """Per-component renormalization so every Cartesian AO has unit self-
    overlap, given shell coefficients normalized for the (l,0,0) component.

    The ratio of self-overlaps is (2i-1)!!(2j-1)!!(2k-1)!!/(2l-1)!!; we scale
    by the inverse square root.
    """
    dfl = double_factorial(2 * l - 1)
    return np.array(
        [
            np.sqrt(dfl / (double_factorial(2 * i - 1) * double_factorial(2 * j - 1) * double_factorial(2 * k - 1)))
            for (i, j, k) in cart_components(l)
        ],
        dtype=np.float64,
    )
