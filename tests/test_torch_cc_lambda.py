"""Port parity, CC Lambda and the unrelaxed CCSD dipole: the port's GMRES
against scipy's on a seeded nonsymmetric system, the Lambda solution's
stationarity, and ``ccsd_dipole`` on water/STO-3G against the
JAX package's (each package's own SCF at diag_rms 1e-10; dipoles within
1e-8 a.u.); and the port's ``ccsd --dipole`` beside the JAX CLI's, every
printed line equal but for the wall time and the SCF count (here rather
than in test_torch_cli.py, so the JAX CLI reuses the Lambda programs that
the JAX run of this file compiled)."""

import os

import numpy as np
import pytest
import scipy.sparse.linalg
import torch

from qchem_rs_tpu import HartreeFockConfig as JaxConfig
from qchem_rs_tpu import cli as jax_cli
from qchem_rs_tpu.models import cc_lambda as jax_cc_lambda
from qchem_rs_tpu.utils.basis import BasisSet as JaxBasisSet
from qchem_rs_tpu.utils.system import MolecularSystem as JaxSystem
from qchem_rs_tpu_torch import BasisSet, HartreeFockConfig, MolecularSystem, cli
from qchem_rs_tpu_torch.models import cc_lambda
from qchem_rs_tpu_torch.models.gmres import gmres
from tests.test_torch_cli import _files, _post_hf_printed, _run
from tests.torch_threads import one_torch_thread  # noqa: F401

DATA = os.path.join(os.path.dirname(__file__), "..", "data")
DIPOLE_TOL = 1e-8  # a.u.
ENERGY_TOL = 1e-10  # Eh


def _systems(mol, basis):
    mpath = os.path.join(DATA, "mol", f"{mol}.json")
    bpath = os.path.join(DATA, "basis", f"{basis}.json")
    return (MolecularSystem.load(mpath, BasisSet.load(bpath)),
            JaxSystem.load(mpath, JaxBasisSet.load(bpath)))


def _system_matrix(n=60, seed=4):
    rng = np.random.default_rng(seed)
    A = np.diag(np.linspace(1.0, 8.0, n)) + 0.3 * rng.standard_normal((n, n)) / np.sqrt(n)
    return A, rng.standard_normal(n)


@pytest.mark.parametrize("restart", [5, 40])
def test_gmres_matches_scipy(restart):
    """A seeded nonsymmetric system with the diagonal preconditioner:
    the port's GMRES and scipy's reach the same solution (relative 1e-10)
    and the residual the tolerance asks for."""
    A, b = _system_matrix()
    d = np.diag(A).copy()
    x_ref, info = scipy.sparse.linalg.gmres(A, b, rtol=1e-12, restart=restart,
                                            maxiter=200, M=np.diag(1.0 / d))
    assert info == 0
    At = torch.as_tensor(A)
    x, info = gmres(lambda v: At @ v, torch.as_tensor(b), M=lambda v: v / torch.as_tensor(d),
                    tol=1e-12, restart=restart, maxiter=200)
    assert info == 0
    x = x.numpy()
    assert np.linalg.norm(x - x_ref) <= 1e-10 * np.linalg.norm(x_ref)
    assert np.linalg.norm(A @ x - b) <= 1e-10 * np.linalg.norm(b)


def test_gmres_on_tensor_tuples_matches_the_flat_solve():
    A, b = _system_matrix(n=30, seed=8)
    At = torch.as_tensor(A)

    def op(v):
        flat = At @ torch.cat([v[0].reshape(-1), v[1].reshape(-1)])
        return (flat[:6].reshape(2, 3), flat[6:].reshape(4, 6))

    bt = torch.as_tensor(b)
    x, info = gmres(op, (bt[:6].reshape(2, 3), bt[6:].reshape(4, 6)), tol=1e-12, restart=30)
    flat = torch.cat([x[0].reshape(-1), x[1].reshape(-1)]).numpy()
    assert info == 0 and np.allclose(flat, np.linalg.solve(A, b), rtol=0, atol=1e-10)


@pytest.fixture(scope="module")
def water_ctx():
    port, _ = _systems("water", "STO-3G")
    cfg = HartreeFockConfig(epsilon=1e-10, max_iterations=100)
    ctx = cc_lambda._setup(port, cfg, 1e-10, torch.device("cpu"))
    lam, rn = cc_lambda._solve_lambda(ctx)
    return ctx, lam, rn


def test_lambda_makes_the_lagrangian_stationary(water_ctx):
    """lam . dG/dt + dE/dt = 0: the directional derivative of the
    Lagrangian along a seeded direction of t vanishes."""
    ctx, lam, rn = water_ctx
    rng = np.random.default_rng(2)
    t = ctx["t"]
    dt = tuple(torch.as_tensor(rng.standard_normal(x.shape)) for x in t)

    def lagrangian(ts):
        G = ctx["G"](ts)
        return ctx["E"](ts) + sum(torch.sum(l * g) for l, g in zip(lam, G))

    _, d = torch.func.jvp(lagrangian, (t,), (dt,))
    assert abs(float(d)) <= 1e-8 and rn <= 1e-8


def test_ccsd_dipole_matches_jax():
    port, jsys = _systems("water", "STO-3G")
    cfg = dict(epsilon=1e-10, max_iterations=100)
    res = cc_lambda.ccsd_dipole(port, HartreeFockConfig(**cfg), device="cpu")
    ref = jax_cc_lambda.ccsd_dipole(jsys, JaxConfig(**cfg))
    assert np.max(np.abs(res.ccsd_dipole - ref.ccsd_dipole)) <= DIPOLE_TOL
    assert np.max(np.abs(res.scf_dipole - ref.scf_dipole)) <= DIPOLE_TOL
    # each package ran its own SCF, whose stops differ by ~1e-10 Eh: compare
    # what CC adds to it
    assert abs((res.ccsd_total_energy - res.scf_total_energy)
               - (ref.ccsd_total_energy - ref.scf_total_energy)) <= ENERGY_TOL
    assert res.lambda_iterations == ref.lambda_iterations


def test_ccsd_dipole_cli_prints_the_jax_lines(capsys):
    argv = ["ccsd", *_files("water"), "--epsilon", "1e-10", "--dipole"]
    rc_ref, ref = _run(jax_cli.main, argv, capsys)
    rc, out = _run(cli.main, argv, capsys, ("--device", "cpu"))
    assert rc == rc_ref == 0 and out[-1].startswith("ccsd dipole (unrelaxed, a.u.): [")
    assert _post_hf_printed(out) == _post_hf_printed(ref)


def test_ccsd_dipole_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the test covers the machine without it")
    port, _ = _systems("hydrogen", "STO-3G")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cc_lambda.ccsd_dipole(port)
