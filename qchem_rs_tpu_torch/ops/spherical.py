"""Cartesian -> real solid-harmonic (spherical) basis transforms (copy of
``qchem_rs_tpu/ops/spherical.py``, numpy only).

The engine computes in Cartesian Gaussians and, for a spherical system,
projects onto the 2l+1-dimensional harmonic subspace of each shell (5d/7f),
the convention of most published HF numbers. The degree-l harmonic
polynomials are the null space of the Laplacian acting on degree-l
monomials; any basis of that space orthonormal in the Gaussian-weighted
inner product serves, since energies depend only on the span. Columns are
deterministic (SVD null space, then a symmetric orthonormalisation).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from qchem_rs_tpu_torch.ops.angular import cart_components, double_factorial


def nsph(l: int) -> int:
    return 2 * l + 1


@lru_cache(maxsize=None)
def _gauss_metric(l: int) -> np.ndarray:
    """<mono_a | mono_b> for unit-exponent same-centre Gaussians, up to a
    common positive factor: the product of (a_d + b_d - 1)!! over the three
    dimensions when every a_d + b_d is even, else 0."""
    comps = cart_components(l)
    n = len(comps)
    M = np.zeros((n, n))
    for i, a in enumerate(comps):
        for j, b in enumerate(comps):
            if all((ad + bd) % 2 == 0 for ad, bd in zip(a, b)):
                M[i, j] = np.prod([double_factorial(ad + bd - 1) for ad, bd in zip(a, b)])
    return M


@lru_cache(maxsize=None)
def cart_to_sph(l: int) -> np.ndarray:
    """(ncart(l), nsph(l)) transform from unit-normalised Cartesian AOs to
    orthonormal spherical AOs (the identity for l < 2)."""
    comps = cart_components(l)
    n = len(comps)
    if l < 2:
        return np.eye(n)
    lower = cart_components(l - 2)
    idx = {c: i for i, c in enumerate(lower)}
    lap = np.zeros((len(lower), n))
    for j, (a, b, c) in enumerate(comps):
        if a >= 2:
            lap[idx[(a - 2, b, c)], j] += a * (a - 1)
        if b >= 2:
            lap[idx[(a, b - 2, c)], j] += b * (b - 1)
        if c >= 2:
            lap[idx[(a, b, c - 2)], j] += c * (c - 1)
    _, s, vt = np.linalg.svd(lap)
    null = vt[np.sum(s > 1e-10):].T  # (n, 2l+1)
    if null.shape[1] != nsph(l):
        raise RuntimeError(f"harmonic subspace of l={l} has dimension {null.shape[1]}")
    # orthonormalise in the Gaussian metric
    M = _gauss_metric(l)
    w, U = np.linalg.eigh(null.T @ M @ null)
    T = null @ (U / np.sqrt(w)[None, :]) @ U.T  # T^T M T = I
    # in terms of unit-normalised Cartesian AOs, mono_a / sqrt(M_aa)
    return T * np.sqrt(np.diag(M))[:, None]


def system_transform(system) -> np.ndarray:
    """Block-diagonal (nao_cart, nao_sph) transform of a whole system, one
    ``cart_to_sph`` block per shell in shell order."""
    blocks = [cart_to_sph(s.l) for s in system.shells]
    T = np.zeros((sum(b.shape[0] for b in blocks), sum(b.shape[1] for b in blocks)))
    i = j = 0
    for b in blocks:
        T[i : i + b.shape[0], j : j + b.shape[1]] = b
        i += b.shape[0]
        j += b.shape[1]
    return T
