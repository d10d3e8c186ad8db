"""Port parity, the whole in-core RHF slice: ``qchem_rs_tpu_torch`` on the CPU
(every kernel through its plain twin) against the JAX package's
``restricted_hartree_fock``, against fixed anchors, and through its CLI."""

import argparse
import os
import re

import numpy as np
import pytest
import torch

from qchem_rs_tpu import HartreeFockConfig as JaxConfig
from qchem_rs_tpu import restricted_hartree_fock as jax_rhf
from qchem_rs_tpu.models.rhf import _incore_tools
from qchem_rs_tpu.utils.basis import BasisSet as JaxBasisSet
from qchem_rs_tpu.utils.system import MolecularSystem as JaxSystem
from qchem_rs_tpu_torch import BasisSet, HartreeFockConfig, MolecularSystem, restricted_hartree_fock
from qchem_rs_tpu_torch import cli
from qchem_rs_tpu_torch.models.sad import CACHE_ENV
from qchem_rs_tpu_torch.ops.eri_tiled import TiledEriEngine
from qchem_rs_tpu_torch.utils.interop import system_from_numpy
from tests.torch_threads import one_torch_thread  # noqa: F401

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


def test_finish_eri_matches_jax_water_sto3g(water_sto3g):
    jax_sys, cfg, _ = water_sto3g
    _, jax_eng = _incore_tools(jax_sys, cfg)
    ref = np.asarray(jax_eng.finish_eri(jax_eng.build()))
    eng = TiledEriEngine(_port_system("water", "STO-3G"), 1e-12, device="cpu")
    out = eng.finish_eri(eng.build()).numpy()
    assert out.shape == ref.shape == (7, 7, 7, 7)
    assert np.max(np.abs(out - ref)) / np.max(np.abs(ref)) <= 1e-11
    # chemists' symmetries: (ij|kl) = (ji|kl) = (kl|ij)
    np.testing.assert_array_equal(out, out.transpose(1, 0, 2, 3))
    np.testing.assert_array_equal(out, out.transpose(2, 3, 0, 1))


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
    # "dense" is a Fock mode the JAX package lacks too; level shifting and
    # external fields are ported (tests/test_torch_scf_options.py)
    system = _port_system("hydrogen", "STO-3G")
    for cfg in (HartreeFockConfig(fock_mode="dense"), HartreeFockConfig(initial_guess="core")):
        with pytest.raises(NotImplementedError):
            restricted_hartree_fock(system, cfg, device="cpu")


@pytest.mark.parametrize("mode,keys", [("pair", {"eri_s", "scf_s", "total_s"}),
                                       ("direct", {"scf_s", "total_s"})])
def test_rhf_fock_modes_match_jax_water_sto3g(water_sto3g, mode, keys):
    _, _, ref = water_sto3g
    out = restricted_hartree_fock(_port_system("water", "STO-3G"),
                                  HartreeFockConfig(epsilon=1e-10, fock_mode=mode), device="cpu")
    assert out.converged
    assert abs(out.total_energy() - ref.total_energy()) <= 1e-9
    assert abs(out.iterations - ref.iterations) <= 1
    assert set(out.timings) == keys


def test_rhf_starts_from_a_jax_density(water_sto3g):
    # the converged JAX density carried over as numpy is a fixed point of
    # the port's in-core SCF: it stops at the first pass that can test it
    _, _, ref = water_sto3g
    out = restricted_hartree_fock(_port_system("water", "STO-3G"), HartreeFockConfig(epsilon=1e-8),
                                  density_guess=ref.density, device="cpu")
    assert out.converged and out.iterations <= 1
    assert abs(out.total_energy() - ref.total_energy()) <= 1e-9
    with pytest.raises(ValueError, match="shape"):
        restricted_hartree_fock(_port_system("water", "STO-3G"), density_guess=ref.density[:3],
                                device="cpu")


def test_sad_rhf_water_ccpvdz_same_fixed_point_no_more_iterations(tmp_path, monkeypatch):
    monkeypatch.setenv(CACHE_ENV, str(tmp_path))
    system = _port_system("water", "cc-pVDZ")
    cfg = HartreeFockConfig(epsilon=1e-10)
    huckel = restricted_hartree_fock(system, cfg, device="cpu")
    sad = restricted_hartree_fock(system, HartreeFockConfig(epsilon=1e-10, initial_guess="sad"),
                                  device="cpu")
    assert huckel.converged and sad.converged
    assert abs(sad.total_energy() - huckel.total_energy()) <= 1e-8
    assert sad.iterations <= huckel.iterations
    assert set(sad.timings) == {"guess_s", "one_electron_s", "eri_s", "scf_s", "total_s"}


@pytest.mark.parametrize("flags", [
    ["--fock-mode", "direct", "--guess", "sad"],
    ["--fock-mode", "pair", "--screening-threshold", "1e-10"],
])
def test_cli_rhf_fock_mode_guess_and_screening_flags(capsys, tmp_path, monkeypatch, flags):
    monkeypatch.setenv(CACHE_ENV, str(tmp_path))
    rc = cli.main([
        "rhf", "-b", os.path.join(DATA, "basis", "STO-3G.json"),
        "-m", os.path.join(DATA, "mol", "water.json"), "--device", "cpu", *flags,
    ])
    assert rc == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 5 and lines[3] == "hartree fock energy: -74.963"


def test_rhf_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the test covers the machine without it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        restricted_hartree_fock(_port_system("hydrogen", "STO-3G"), HartreeFockConfig())


@pytest.mark.parametrize("mode", ["incore", "direct"])
def test_espan_rhf_matches_jax_water_sto3g(water_sto3g, mode):
    # the energy-span stop (window 4, guard 1e-6 on diag_rms) kept on the
    # host: the JAX in-core run's iteration count and, to 1e-10, its energy
    # (the two runs agree to ~1e-13 Eh pass by pass, far inside the span
    # epsilon of 1e-10, so they stop at the same pass)
    jax_sys, _, _ = water_sto3g
    ref = jax_rhf(jax_sys, JaxConfig(epsilon=1e-10, convergence_metric="espan:4"))
    out = restricted_hartree_fock(
        _port_system("water", "STO-3G"),
        HartreeFockConfig(epsilon=1e-10, convergence_metric="espan:4", fock_mode=mode),
        device="cpu")
    assert ref.converged and out.converged
    assert out.iterations == ref.iterations
    assert abs(out.total_energy() - ref.total_energy()) <= 1e-10


def test_espan_window_and_cli(capsys):
    """A window outside 2..8 raises in the config; the port's and the JAX
    CLI's --convergence types accept and reject the same values, with the
    same espan messages; the CLI's rhf runs the rule and prints the
    in-process energy."""
    from qchem_rs_tpu import cli as jax_cli

    system = _port_system("water", "STO-3G")
    with pytest.raises(ValueError, match="espan window 9 outside 2..8"):
        restricted_hartree_fock(system, HartreeFockConfig(convergence_metric="espan:9"),
                                device="cpu")
    for value in ("espan", "espan:2", "espan:8:1e-8", "espan:1", "espan:9", "espan:x",
                  "espan:4:y", "espan:", "diag_rms", "composite:1e-7", "energy2"):
        outcome = []
        for parse in (jax_cli._convergence_metric, cli._convergence_metric):
            try:
                outcome.append(parse(value))
            except argparse.ArgumentTypeError as e:  # the espan messages match too
                outcome.append(("rejected", str(e) if value.startswith("espan") else None))
        assert outcome[0] == outcome[1], value
    out = restricted_hartree_fock(
        system, HartreeFockConfig(epsilon=1e-10, convergence_metric="espan:4"), device="cpu")
    rc = cli.main(["rhf", "-b", os.path.join(DATA, "basis", "STO-3G.json"),
                   "-m", os.path.join(DATA, "mol", "water.json"), "--device", "cpu",
                   "--convergence", "espan:4", "--epsilon", "1e-10"])
    lines = capsys.readouterr().out.splitlines()
    assert rc == 0
    assert lines[0].startswith(f"hartree fock converged after {out.iterations} iterations")
    assert lines[3] == f"hartree fock energy: {out.total_energy():.3f}"
