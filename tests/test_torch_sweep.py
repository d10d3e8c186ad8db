"""Port parity, conformer sweeps: ``parallel.sweep.conformer_sweep`` and
``chained_sweep`` on the CPU against the JAX package's, on water/STO-3G,
and the ``sweep`` subcommand (with and without ``--chain``) against the
JAX CLI's lines, wall time masked. The CLI cases sit beside the JAX
functions they run, which share this process's compiled programs. The
pair and direct chains are in ``test_torch_sweep_chain.py``."""

import json
import os
import re

import numpy as np
import pytest

from qchem_rs_tpu import HartreeFockConfig as JaxConfig
from qchem_rs_tpu import cli as jax_cli
from qchem_rs_tpu.parallel.sweep import chained_sweep as jax_chained_sweep
from qchem_rs_tpu.parallel.sweep import conformer_sweep as jax_conformer_sweep
from qchem_rs_tpu.utils.basis import BasisSet as JaxBasisSet
from qchem_rs_tpu.utils.system import MolecularSystem as JaxSystem
from qchem_rs_tpu_torch import BasisSet, HartreeFockConfig, MolecularSystem, cli
from qchem_rs_tpu_torch.parallel.sweep import chained_sweep, conformer_sweep, rhf_energy_fn
from qchem_rs_tpu_torch import restricted_hartree_fock
from tests.test_torch_cli import _files, _run
from tests.torch_threads import one_torch_thread  # noqa: F401

DATA = os.path.join(os.path.dirname(__file__), "..", "data")
SCALES = (0.95, 1.0, 1.05, 1.1)
#: the CLI's default cap, so that the JAX CLI's runs are the JAX functions'
CFG = dict(epsilon=1e-12, max_iterations=100)


def _paths():
    return os.path.join(DATA, "mol", "water.json"), os.path.join(DATA, "basis", "STO-3G.json")


@pytest.fixture(scope="module")
def systems():
    mpath, bpath = _paths()
    return (MolecularSystem.load(mpath, BasisSet.load(bpath)),
            JaxSystem.load(mpath, JaxBasisSet.load(bpath)))


def _geometries(system, scales):
    return np.stack([np.asarray(system.positions) * s for s in scales])


@pytest.fixture(scope="module")
def jax_sweep(systems):
    _, jsys = systems
    return jax_conformer_sweep(jsys, _geometries(jsys, SCALES), JaxConfig(**CFG))


def test_conformer_sweep_matches_jax(systems, jax_sweep):
    system, _ = systems
    energies, converged = conformer_sweep(system, _geometries(system, SCALES),
                                          HartreeFockConfig(**CFG), device="cpu")
    ref_e, ref_c = jax_sweep
    assert np.array_equal(converged, ref_c) and converged.all()
    assert np.abs(energies - ref_e).max() <= 1e-10
    assert np.ptp(energies) > 1e-3


def test_rhf_energy_fn_equals_the_entry_point(systems):
    # in core from Hückel: the same bits as restricted_hartree_fock
    system, _ = systems
    cfg = HartreeFockConfig(epsilon=1e-10)
    pos = _geometries(system, (1.05,))[0]
    total, conv, iterations, density = rhf_energy_fn(system, cfg, "cpu")(pos)
    out = restricted_hartree_fock(system.with_positions(pos), cfg, device="cpu")
    assert conv and total == out.total_energy() and iterations == out.iterations
    assert np.array_equal(density.numpy(), out.density)


def chained_matches_jax(systems, mode, scales):
    system, jsys = systems
    energies, converged = chained_sweep(system, _geometries(system, scales),
                                        HartreeFockConfig(**CFG, fock_mode=mode), device="cpu")
    ref_e, ref_c = jax_chained_sweep(jsys, _geometries(jsys, scales),
                                     JaxConfig(**CFG, fock_mode=mode))
    assert np.array_equal(converged, ref_c) and converged.all()
    assert np.abs(energies - ref_e).max() <= 1e-10


def test_chained_sweep_in_core_matches_jax(systems):
    chained_matches_jax(systems, "incore", SCALES)


def _masked(lines):
    return [re.sub(r"in \d+\.\d\ds$", "in <t>s", line) for line in lines]


@pytest.mark.parametrize("chain", [False, True], ids=["batch", "chain"])
def test_cli_sweep_prints_the_jax_lines(systems, jax_sweep, tmp_path, capsys, chain):
    system, _ = systems
    path = tmp_path / "geometries.json"
    path.write_text(json.dumps(_geometries(system, SCALES).tolist()))
    argv = ["sweep", *_files("water"), "-g", str(path), "--epsilon", str(CFG["epsilon"])]
    argv += ["--chain"] if chain else []
    rc_ref, ref = _run(jax_cli.main, argv, capsys)
    rc, out = _run(cli.main, argv, capsys, ("--device", "cpu"))
    assert rc == rc_ref == 0
    assert len(out) == 1 + len(SCALES) and _masked(out) == _masked(ref)
    assert out[0].startswith(f"swept {len(SCALES)} conformers in ")
