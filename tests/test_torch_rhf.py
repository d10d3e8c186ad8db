"""Port parity, the whole in-core RHF slice: ``qchem_rs_tpu_torch`` on the CPU
(every kernel through its plain twin) against the JAX package's
``restricted_hartree_fock``, against fixed anchors, and through its CLI."""

import os
import re

import numpy as np
import pytest

from qchem_rs_tpu import HartreeFockConfig as JaxConfig
from qchem_rs_tpu import restricted_hartree_fock as jax_rhf
from qchem_rs_tpu.models.rhf import _incore_tools
from qchem_rs_tpu.utils.basis import BasisSet as JaxBasisSet
from qchem_rs_tpu.utils.system import MolecularSystem as JaxSystem
from qchem_rs_tpu_torch import BasisSet, HartreeFockConfig, MolecularSystem, restricted_hartree_fock
from qchem_rs_tpu_torch import cli
from qchem_rs_tpu_torch.ops.eri_tiled import TiledEriEngine
from qchem_rs_tpu_torch.utils.interop import system_from_numpy

DATA = os.path.join(os.path.dirname(__file__), "..", "data")


def _port_system(mol, basis):
    return MolecularSystem.load(
        os.path.join(DATA, "mol", f"{mol}.json"),
        BasisSet.load(os.path.join(DATA, "basis", f"{basis}.json")),
    )


@pytest.fixture(scope="module")
def water_sto3g():
    """JAX reference run on water/STO-3G at epsilon 1e-10, its system and
    config; the JAX package keeps the run's tiled engine for reuse."""
    jax_sys = JaxSystem.load(
        os.path.join(DATA, "mol", "water.json"),
        JaxBasisSet.load(os.path.join(DATA, "basis", "STO-3G.json")),
    )
    cfg = JaxConfig(epsilon=1e-10)
    return jax_sys, cfg, jax_rhf(jax_sys, cfg)


def test_rhf_matches_jax_water_sto3g(water_sto3g):
    jax_sys, _, ref = water_sto3g
    system = system_from_numpy(
        jax_sys.charges.astype(int), jax_sys.positions,
        BasisSet.load(os.path.join(DATA, "basis", "STO-3G.json")),
    )
    out = restricted_hartree_fock(system, HartreeFockConfig(epsilon=1e-10), device="cpu")
    assert ref.converged and out.converged
    assert abs(out.total_energy() - ref.total_energy()) <= 1e-9
    np.testing.assert_allclose(out.orbital_energies, ref.orbital_energies, rtol=0, atol=1e-8)
    assert out.iterations == ref.iterations
    assert set(out.timings) == {"one_electron_s", "eri_s", "scf_s", "total_s"}


def test_finish_terms_matches_jax_water_sto3g(water_sto3g):
    jax_sys, cfg, _ = water_sto3g
    _, jax_eng = _incore_tools(jax_sys, cfg)  # the reference run's engine
    ref = np.asarray(jax_eng.finish_terms(jax_eng.build()))
    eng = TiledEriEngine(_port_system("water", "STO-3G"), 1e-12, device="cpu")
    out = eng.finish_terms(eng.build()).numpy()
    assert out.shape == ref.shape == (49, 49)
    assert np.max(np.abs(out - ref)) / np.max(np.abs(ref)) <= 1e-11


def test_rhf_water_ccpvdz_anchor():
    # the JAX package's CPU fixed point at diag_rms 1e-10 (bench.py:54)
    out = restricted_hartree_fock(
        _port_system("water", "cc-pVDZ"), HartreeFockConfig(epsilon=1e-10), device="cpu"
    )
    assert out.converged
    assert abs(out.total_energy() - -76.02713907) <= 1e-8
    assert abs(out.iterations - 19) <= 1


def test_rhf_h2_sto3g_anchor():
    out = restricted_hartree_fock(
        _port_system("hydrogen", "STO-3G"), HartreeFockConfig(epsilon=1e-10), device="cpu"
    )
    assert out.converged
    assert abs(out.total_energy() - -1.116714325) <= 1e-8


def test_cli_rhf_prints_five_lines(capsys):
    rc = cli.main([
        "rhf", "-b", os.path.join(DATA, "basis", "STO-3G.json"),
        "-m", os.path.join(DATA, "mol", "water.json"), "--device", "cpu",
    ])
    assert rc == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 5
    assert re.fullmatch(r"hartree fock converged after \d+ iterations and \d+\.\d\ds", lines[0])
    assert re.fullmatch(r"electronic energy: -\d+\.\d{3}", lines[1])
    assert re.fullmatch(r"nuclear repulsion energy: \d+\.\d{3}", lines[2])
    assert lines[3] == "hartree fock energy: -74.963"
    assert re.fullmatch(r"orbital energies: \[(-?\d+\.\d{3}, ){6}-?\d+\.\d{3}\]", lines[4])


def test_cli_without_cuda_exits_with_one_line(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the test covers the machine without it")
    rc = cli.main([
        "rhf", "-b", os.path.join(DATA, "basis", "STO-3G.json"),
        "-m", os.path.join(DATA, "mol", "water.json"),
    ])
    err = capsys.readouterr().err.splitlines()
    assert rc == 2
    assert len(err) == 1 and err[0].startswith("error: device 'cuda'")


def test_rhf_rejects_unported_options():
    system = _port_system("hydrogen", "STO-3G")
    for cfg in (HartreeFockConfig(fock_mode="pair"), HartreeFockConfig(initial_guess="sad"),
                HartreeFockConfig(level_shift=0.1)):
        with pytest.raises(NotImplementedError):
            restricted_hartree_fock(system, cfg, device="cpu")
