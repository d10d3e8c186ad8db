"""Pulay (commutator) DIIS with a masked fixed window (port of
``qchem_rs_tpu/models/diis.py:43-75``).

Push the newest (error, fock) sample into a ring of ``max_len`` slots, pass
the newest Fock through until ``min_len`` samples exist, otherwise solve the
bordered system

    [ <e_i, e_j>  1 ] [c]   [0]
    [    1        0 ] [λ] = [1]

and return sum_i c_i F_i. Empty slots are masked out of B with identity rows
forcing their coefficients to zero. The system is solved by an SVD
least-squares solve with the cut-off of ``jnp.linalg.lstsq`` (singular
values below eps * (M+1) * s_max dropped): it degrades gracefully when the
error vectors become linearly dependent near convergence, and it gives the
JAX package's iteration counts. ``torch.linalg.lstsq`` on CUDA only has the
QR driver, which assumes full rank.
"""

from __future__ import annotations

import torch


class Diis:
    """The DIIS history of one SCF run."""

    def __init__(self, max_len: int, min_len: int, n: int, device):
        self.min_len = min_len
        self.errors = torch.zeros((max_len, n, n), dtype=torch.float64, device=device)
        self.focks = torch.zeros((max_len, n, n), dtype=torch.float64, device=device)
        self.count = 0

    def apply(self, error: torch.Tensor, fock: torch.Tensor) -> torch.Tensor:
        """Push a sample and return the (possibly extrapolated) Fock matrix."""
        M = self.errors.shape[0]
        slot = self.count % M
        self.errors[slot] = error
        self.focks[slot] = fock
        self.count += 1
        m = min(self.count, M)  # current window size
        if m < self.min_len:
            return fock
        dev = error.device
        valid = torch.arange(M, device=dev) < m
        B = torch.einsum("iab,jab->ij", self.errors, self.errors)
        B = torch.where(valid[:, None] & valid[None, :], B, 0.0)
        B = B + torch.diag((~valid).to(B.dtype))
        border = valid.to(B.dtype)
        Bfull = torch.zeros((M + 1, M + 1), dtype=B.dtype, device=dev)
        Bfull[:M, :M] = B
        Bfull[:M, M] = border
        Bfull[M, :M] = border
        rhs = torch.zeros(M + 1, dtype=B.dtype, device=dev)
        rhs[M] = 1.0
        coef = lstsq_svd(Bfull, rhs)[:M]
        coef = torch.where(valid, coef, 0.0)
        return torch.einsum("i,iab->ab", coef, self.focks)


def lstsq_svd(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Minimum-norm least-squares solution of a x = b by SVD, dropping
    singular values below eps * max(a.shape) * s_max (the default ``rcond``
    of ``jnp.linalg.lstsq``)."""
    U, s, Vh = torch.linalg.svd(a)
    keep = (s > 0) & (s >= torch.finfo(a.dtype).eps * max(a.shape) * s[0])
    inv = torch.where(keep, 1.0 / torch.where(keep, s, 1.0), 0.0)
    return Vh.T @ (inv * (U.T @ b))
