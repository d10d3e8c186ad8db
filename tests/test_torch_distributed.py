"""Port, real process groups on the CPU: ``parallel.mesh.distributed_init``
joins gloo workers started as torchrun would start them (MASTER_ADDR,
MASTER_PORT, WORLD_SIZE, RANK, LOCAL_RANK), each a subprocess with one
torch thread and a 120 s timeout (never a process group inside the pytest
worker). Two and three processes run the three sharded builders, whose J
and K are held against the JAX package's pair-space build and against a
second run (equal bits); two processes run a conformer sweep."""

import os
import socket
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qchem_rs_tpu.ops.fock_pair import PairSpaceFockBuilder as JaxPairBuilder
from qchem_rs_tpu.utils.basis import BasisSet as JaxBasisSet
from qchem_rs_tpu.utils.system import MolecularSystem as JaxSystem
from qchem_rs_tpu_torch import BasisSet, HartreeFockConfig, MolecularSystem
from qchem_rs_tpu_torch.parallel.mesh import TORCHRUN_ENV, distributed_init
from qchem_rs_tpu_torch.parallel.sweep import conformer_sweep
from tests.torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
DATA = os.path.join(ROOT, "data")
#: builder -> (molecule, basis): the pair builder on methane/3-21G (M =
#: 228, which 2 and 3 divide) and on water/STO-3G (M = 37, which they do
#: not: shares of unequal width)
CASES = {"stream": ("water", "STO-3G"), "column": ("water", "STO-3G"),
         "pair": ("methane", "3-21G"), "pair_water": ("water", "STO-3G")}
SCALES = (0.95, 1.0, 1.05, 1.1)

_WORKER = textwrap.dedent(
    """
    import os, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    from qchem_rs_tpu_torch import BasisSet, HartreeFockConfig, MolecularSystem
    from qchem_rs_tpu_torch.ops.fock_pair import PairSpaceShardedFockBuilder
    from qchem_rs_tpu_torch.parallel.fock_sharded import ShardedFockBuilder
    from qchem_rs_tpu_torch.parallel.mesh import data_mesh, distributed_init
    from qchem_rs_tpu_torch.parallel.sweep import conformer_sweep
    from qchem_rs_tpu_torch.parallel.v2_sharded import ColumnShardedPairFockBuilder

    task, out, data = sys.argv[1], sys.argv[2], sys.argv[3]
    assert distributed_init(device="cpu") and distributed_init(device="cpu")
    mesh = data_mesh(device="cpu")
    assert (mesh.rank, mesh.size) == (dist.get_rank(), dist.get_world_size())

    def load(mol, basis):
        return MolecularSystem.load(os.path.join(data, "mol", mol + ".json"),
                                    BasisSet.load(os.path.join(data, "basis", basis + ".json")))

    if task == "all_reduce":
        t = torch.tensor([mesh.rank + 1.0], dtype=torch.float64)
        mesh.all_reduce(t)
        parts = mesh.all_gather(torch.tensor([[float(mesh.rank)]]), dim=1)
        assert float(t) == mesh.size * (mesh.size + 1) / 2 and parts.tolist() == [[0.0, 1.0]]
    elif task == "builders":
        for name, cls, mol, basis in (("stream", ShardedFockBuilder, "water", "STO-3G"),
                                      ("column", ColumnShardedPairFockBuilder, "water", "STO-3G"),
                                      ("pair", PairSpaceShardedFockBuilder, "methane", "3-21G"),
                                      ("pair_water", PairSpaceShardedFockBuilder, "water", "STO-3G")):
            system = load(mol, basis)
            n = system.n_basis()
            D = np.random.default_rng(7).standard_normal((n, n))
            for run in "ab":  # a second run with a new builder
                J, K = cls(system, mesh, 1e-12).jk(torch.tensor(D + D.T))
                if mesh.rank == 0:
                    np.save(os.path.join(out, f"{name}_J{run}.npy"), J.numpy())
                    np.save(os.path.join(out, f"{name}_K{run}.npy"), K.numpy())
    elif task == "sweep":
        system = load("water", "STO-3G")
        pos = np.asarray(system.positions)
        geoms = np.stack([pos * s for s in (0.95, 1.0, 1.05, 1.1)])
        e, c = conformer_sweep(system, geoms, HartreeFockConfig(epsilon=1e-10), mesh)
        if mesh.rank == 0:
            np.save(os.path.join(out, "energies.npy"), e)
            np.save(os.path.join(out, "converged.npy"), c)
    dist.destroy_process_group()
    print("WORKER_OK", mesh.rank, flush=True)
    """
)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _cluster(size: int, task: str, out) -> None:
    """Run the worker ``task`` on ``size`` gloo processes; fail unless
    each ends cleanly within 120 s."""
    port = _free_port()
    procs = []
    for rank in range(size):
        env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   WORLD_SIZE=str(size), RANK=str(rank), LOCAL_RANK=str(rank),
                   PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen([sys.executable, "-c", _WORKER, task, str(out), DATA],
                                      env=env, cwd=ROOT, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
    results = []
    try:
        for p in procs:
            results.append(p.communicate(timeout=120))
    except subprocess.TimeoutExpired:
        pytest.fail(f"a gloo worker of {task} on {size} processes timed out")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for (out_text, err), p in zip(results, procs):
        assert p.returncode == 0 and "WORKER_OK" in out_text, f"worker failed: {err[-3000:]}"


def test_distributed_init_is_false_without_torchrun(monkeypatch):
    for var in TORCHRUN_ENV + ("LOCAL_RANK",):
        monkeypatch.delenv(var, raising=False)
    assert distributed_init(device="cpu") is False
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "29500")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert distributed_init(device="cpu") is False
    assert not torch.distributed.is_initialized()


def test_two_process_all_reduce(tmp_path):
    _cluster(2, "all_reduce", tmp_path)


@pytest.fixture(scope="module")
def jax_references():
    """The JAX package's pair-space J and K (threshold 1e-12) per builder's
    system, for the workers' density."""
    refs = {}
    for name, (mol, basis) in CASES.items():
        if name in ("column", "pair_water"):  # the streaming builder's system
            refs[name] = refs["stream"]
            continue
        jsys = JaxSystem.load(os.path.join(DATA, "mol", f"{mol}.json"),
                              JaxBasisSet.load(os.path.join(DATA, "basis", f"{basis}.json")))
        n = jsys.n_basis()
        D = np.random.default_rng(7).standard_normal((n, n))
        J, K = JaxPairBuilder(jsys, threshold=1e-12, lean=False).jk(jnp.asarray(D + D.T))
        refs[name] = (np.asarray(J), np.asarray(K))
    return refs


@pytest.mark.parametrize("size", [2, 3])
def test_builders_over_gloo(tmp_path, jax_references, size):
    _cluster(size, "builders", tmp_path)
    for name, (J_ref, K_ref) in jax_references.items():
        J, K = (np.load(tmp_path / f"{name}_{x}a.npy") for x in "JK")
        assert np.abs(J - J_ref).max() <= 1e-11 and np.abs(K - K_ref).max() <= 1e-11, name
        for x, first in (("J", J), ("K", K)):  # the second run: the same bits
            assert np.array_equal(np.load(tmp_path / f"{name}_{x}b.npy"), first), name


def test_conformer_sweep_over_two_processes(tmp_path):
    system = MolecularSystem.load(os.path.join(DATA, "mol", "water.json"),
                                  BasisSet.load(os.path.join(DATA, "basis", "STO-3G.json")))
    pos = np.asarray(system.positions)
    geoms = np.stack([pos * s for s in SCALES])
    energies, converged = conformer_sweep(system, geoms, HartreeFockConfig(epsilon=1e-10),
                                          device="cpu")
    _cluster(2, "sweep", tmp_path)
    assert np.array_equal(np.load(tmp_path / "energies.npy"), energies)
    assert np.array_equal(np.load(tmp_path / "converged.npy"), converged) and converged.all()
    assert np.ptp(energies) > 1e-3
