"""The port's SCF layer on the CPU: Pulay DIIS and its SVD least-squares
solve, the orthogonalization, the Fock eigensolve and the convergence tests
of ``qchem_rs_tpu_torch/models`` against plain numpy references."""

import numpy as np
import pytest
import torch

from qchem_rs_tpu_torch.models import scf
from qchem_rs_tpu_torch.models.diis import Diis, lstsq_svd
from tests.torch_threads import one_torch_thread  # noqa: F401


def _samples(k, n, seed):
    """k (error, fock) pairs: antisymmetric commutator-like errors and
    symmetric Fock matrices, (n, n) each."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(k):
        e = rng.normal(size=(n, n))
        f = rng.normal(size=(n, n))
        out.append((e - e.T, f + f.T))
    return out


def _push(diis, samples):
    for e, f in samples:
        out = diis.apply(torch.tensor(e), torch.tensor(f))
    return out


@pytest.mark.parametrize("m", range(2, 7))
def test_diis_matches_the_bordered_solve(m):
    # a window of m samples in a ring of 6: sum_i c_i F_i with c from the
    # bordered system [B 1; 1 0] [c; l] = [0; 1] solved by numpy
    samples = _samples(m, 5, seed=m)
    out = _push(Diis(6, 2, 5, "cpu"), samples)
    E = np.array([e for e, _ in samples])
    F = np.array([f for _, f in samples])
    A = np.zeros((m + 1, m + 1))
    A[:m, :m] = np.einsum("iab,jab->ij", E, E)
    A[:m, m] = A[m, :m] = 1.0
    rhs = np.zeros(m + 1)
    rhs[m] = 1.0
    c = np.linalg.solve(A, rhs)[:m]
    ref = np.einsum("i,iab->ab", c, F)
    assert np.max(np.abs(out.numpy() - ref)) <= 1e-10 * np.max(np.abs(ref))


def test_diis_passes_the_newest_fock_through_below_min_len():
    samples = _samples(3, 4, seed=9)
    diis = Diis(6, 3, 4, "cpu")
    for e, f in samples[:2]:
        assert torch.equal(diis.apply(torch.tensor(e), torch.tensor(f)), torch.tensor(f))
    e, f = samples[2]
    assert not torch.equal(diis.apply(torch.tensor(e), torch.tensor(f)), torch.tensor(f))


def test_diis_ring_keeps_the_newest_samples():
    samples = _samples(9, 4, seed=10)
    out = _push(Diis(4, 2, 4, "cpu"), samples)
    ref = _push(Diis(4, 2, 4, "cpu"), samples[-4:])
    assert float((out - ref).abs().max()) <= 1e-12 * float(ref.abs().max())


@pytest.mark.parametrize("n,rank", [(6, 6), (6, 3), (7, 1), (7, 5)])
def test_lstsq_svd_matches_numpy_lstsq(n, rank):
    # the minimum-norm solution with jnp/numpy's default cut-off, also
    # where the matrix is singular (DIIS near convergence)
    rng = np.random.default_rng(10 * n + rank)
    a = rng.normal(size=(n, rank)) @ rng.normal(size=(rank, n))
    b = rng.normal(size=n)
    ref = np.linalg.lstsq(a, b, rcond=None)[0]
    out = lstsq_svd(torch.tensor(a), torch.tensor(b)).numpy()
    assert np.max(np.abs(out - ref)) <= 1e-10 * np.max(np.abs(ref))


def _spd(n, seed):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(n, n))
    return a @ a.T + n * np.eye(n)


def test_lowdin_x_orthonormalizes_the_overlap():
    S = torch.tensor(_spd(6, 1))
    X = scf.lowdin_x(S)
    assert torch.allclose(X, X.T, rtol=0, atol=1e-14)
    assert float((X.T @ S @ X - torch.eye(6, dtype=S.dtype)).abs().max()) <= 1e-12


def test_solve_fock_solves_the_generalized_eigenproblem():
    rng = np.random.default_rng(2)
    F = rng.normal(size=(6, 6))
    F, S = torch.tensor(F + F.T), torch.tensor(_spd(6, 3))
    C, w = scf.solve_fock(F, scf.lowdin_x(S))
    assert bool((w[1:] >= w[:-1]).all())
    assert float((F @ C - S @ C * w[None, :]).abs().max()) <= 1e-11
    assert float((C.T @ S @ C - torch.eye(6, dtype=S.dtype)).abs().max()) <= 1e-12


def test_density_from_coeffs_is_idempotent_in_the_overlap_metric():
    # D S D = 2 D for the RHF density of S-orthonormal orbitals
    S = torch.tensor(_spd(6, 4))
    C, _ = scf.solve_fock(torch.tensor(_spd(6, 5)), scf.lowdin_x(S))
    D = scf.density_from_coeffs(C, 2, 2.0)
    assert float((D @ S @ D - 2.0 * D).abs().max()) <= 1e-12
    assert abs(float(torch.trace(D @ S)) - 4.0) <= 1e-12


@pytest.mark.parametrize("metric", ["diag_rms", "full_rms"])
def test_density_rms_matches_its_formula(metric):
    d = np.random.default_rng(6).normal(size=(5, 5))
    ref = np.sqrt(np.sum(np.diag(d) ** 2) / 5) if metric == "diag_rms" else np.sqrt(np.mean(d**2))
    assert abs(float(scf.density_rms(torch.tensor(d), metric)) - ref) <= 1e-15
    with pytest.raises(ValueError, match="unknown convergence metric"):
        scf.density_rms(torch.tensor(d), metric + "x")


@pytest.mark.parametrize(
    "metric,rms,prev,stop",
    [
        ("diag_rms", 1e-9, 1.0, True),
        ("diag_rms", 1e-7, 1e-9, False),
        ("diag_rms2", 1e-9, 1.0, False),
        ("diag_rms2", 1e-9, 1e-9, True),
        ("composite", 1e-9, 1.0, False),
        ("composite:1e-4", 1e-9, 1e-9, True),
    ],
)
def test_converged_flag_needs_two_passes_where_the_metric_says(metric, rms, prev, stop):
    assert scf.converged_flag(metric, rms, prev, 1e-8) is stop
