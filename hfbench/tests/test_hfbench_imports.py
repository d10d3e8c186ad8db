"""Import guard: the benchmark loads no module of JAX or of the JAX
package, and its yardstick imports nothing of the port."""

import ast
import subprocess
import sys
import types

import pytest

from hfbench import run
from hfbench.tests.conftest import ROOT


def test_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "qchem_rs_tpu_torch_probe", types.ModuleType("qchem_rs_tpu_torch_probe"))
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "qchem_rs_tpu.probe", types.ModuleType("qchem_rs_tpu.probe"))
    assert run.forbidden_modules() == ["qchem_rs_tpu"]


SCRIPT = """
import json, sys
from pathlib import Path
from hfbench import run
from hfbench.program import Program
from hfbench.tests.conftest import ROOT
bench = json.loads((ROOT / "BENCHMARK.json").read_text())
for cell in bench["workloads"]:
    _, config, _ = run.resolve(bench, cell["name"], ROOT)
    Program(config, ROOT, "cpu").system
    for m in bench["end_to_end"] + bench["per_layer"]:
        run.reader(m["name"])
import qchem_rs_tpu_torch.models.rhf, qchem_rs_tpu_torch.ops.fock_stream
water = json.loads(sys.argv[1])
result = run.measure(water, "water.md17", 5, 0.5, True, device="cpu")
print(json.dumps({"forbidden": run.forbidden_modules(), "correct": result["correct"]}))
"""


def test_a_run_loads_no_jax(water_bench, tmp_path):
    env = {"PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT), "HOME": str(tmp_path),
           "QCHEM_TORCH_SAD_CACHE": str(tmp_path / "sad"), "OMP_NUM_THREADS": "1"}
    import json

    out = subprocess.run([sys.executable, "-c", SCRIPT, json.dumps(water_bench)], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == {"forbidden": [], "correct": True}


@pytest.mark.parametrize("part", ["reference", "counts"])
def test_yardstick_imports_nothing_of_the_port(part):
    for path in (ROOT / "hfbench" / part).rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                assert name.split(".")[0] not in {"qchem_rs_tpu_torch", "qchem_rs_tpu", "jax", "jaxlib"}, (path, name)


def test_no_card_no_result(tmp_path):
    """Without CUDA the run exits 2 and prints nothing on standard output;
    in a directory holding only BENCHMARK.json and hfbench/ it exits non-zero."""
    import shutil
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    for cwd in (ROOT, tmp_path):
        if cwd == tmp_path:
            shutil.copytree(ROOT / "hfbench", tmp_path / "hfbench",
                            ignore=shutil.ignore_patterns("_cache", "__pycache__"))
            shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
        out = subprocess.run([sys.executable, "-m", "hfbench.run", "--workload", "naphthalene-direct.md17",
                              "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=cwd,
                             capture_output=True, text=True, timeout=300, env={"PATH": "/usr/bin:/bin"})
        assert out.returncode != 0 and out.stdout == ""
