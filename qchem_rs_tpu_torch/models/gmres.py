"""Restarted, left-preconditioned GMRES over tuples of tensors: the
counterpart of ``jax.scipy.sparse.linalg.gmres`` that the Lambda and
z-vector solves of ``cc_lambda`` and ``cc_relaxed`` call.

The Arnoldi basis lives on the tensors' device (re-orthogonalized
classical Gram-Schmidt, one matrix product per pass); the Hessenberg
least-squares problem is solved on the host by Givens rotations, which
also give the residual estimate that ends a cycle early. As in the JAX
solver called with ``atol=0``, the iteration stops when the preconditioned
residual ||M(b - A x)|| falls to tol ||b||, or after ``maxiter`` restart
cycles; the callers check the true residual themselves.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def _flatten(xs) -> torch.Tensor:
    return torch.cat([x.reshape(-1) for x in xs])


def _unflatten(v: torch.Tensor, like) -> tuple:
    out, at = [], 0
    for x in like:
        out.append(v[at : at + x.numel()].reshape(x.shape))
        at += x.numel()
    return tuple(out)


def gmres(A, b, *, tol: float = 1e-5, restart: int = 20, maxiter=None, M=None):
    """Solve A x = b for x. ``A`` and ``M`` (the preconditioner, an
    approximate inverse of A; identity when None) map a tuple of tensors
    shaped like ``b`` to another; ``b`` may also be a single tensor.
    The iteration starts from zero. Returns (x, info): info 0 when the
    tolerance was reached, else the number of restart cycles run."""
    single = torch.is_tensor(b)
    bt = (b,) if single else tuple(b)
    wrap = (lambda f: (lambda xs: (f(xs[0]),))) if single else (lambda f: f)
    A_t = wrap(A)
    M_t = wrap(M) if M is not None else (lambda xs: xs)

    def Af(v):
        return _flatten(A_t(_unflatten(v, bt)))

    def Mf(v):
        return _flatten(M_t(_unflatten(v, bt)))

    bf = _flatten(bt)
    size = bf.numel()
    maxiter = 10 * size if maxiter is None else maxiter
    restart = min(restart, size)
    x = torch.zeros_like(bf)
    thresh = tol * float(torch.linalg.norm(bf))

    r = Mf(bf - Af(x))
    beta = float(torch.linalg.norm(r))
    cycles = 0
    while cycles < maxiter and beta > thresh:
        V = bf.new_zeros((restart + 1, size))
        V[0] = r / beta
        H = np.zeros((restart + 1, restart))
        cs, sn = np.zeros(restart), np.zeros(restart)
        g = np.zeros(restart + 1)
        g[0] = beta
        m = 0
        for j in range(restart):
            w = Mf(Af(V[j]))
            Vj = V[: j + 1]
            h = Vj @ w
            w = w - Vj.T @ h
            h2 = Vj @ w  # the second Gram-Schmidt pass
            w = w - Vj.T @ h2
            H[: j + 1, j] = (h + h2).cpu().numpy()
            hn = float(torch.linalg.norm(w))
            H[j + 1, j] = hn
            for i in range(j):  # earlier rotations on the new column
                a, c = H[i, j], H[i + 1, j]
                H[i, j], H[i + 1, j] = cs[i] * a + sn[i] * c, -sn[i] * a + cs[i] * c
            rho = math.hypot(H[j, j], H[j + 1, j])
            cs[j], sn[j] = (1.0, 0.0) if rho == 0.0 else (H[j, j] / rho, H[j + 1, j] / rho)
            H[j, j], H[j + 1, j] = rho, 0.0
            g[j + 1] = -sn[j] * g[j]
            g[j] = cs[j] * g[j]
            m = j + 1
            if hn <= 1e-300 or abs(g[j + 1]) <= thresh:
                break
            V[j + 1] = w / hn
        y = np.linalg.solve(np.triu(H[:m, :m]), g[:m]) if m else np.zeros(0)
        x = x + V[:m].T @ torch.as_tensor(y, dtype=bf.dtype, device=bf.device)
        r = Mf(bf - Af(x))
        beta = float(torch.linalg.norm(r))
        cycles += 1
    info = 0 if beta <= thresh else cycles
    xs = _unflatten(x, bt)
    return (xs[0] if single else xs), info
