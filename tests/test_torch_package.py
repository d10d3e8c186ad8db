"""The port stands alone: importing every module of ``qchem_rs_tpu_torch``
loads no JAX, and no source line of it imports JAX."""

import os
import pkgutil
import subprocess
import sys

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
PKG = os.path.join(ROOT, "qchem_rs_tpu_torch")


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import qchem_rs_tpu_torch, qchem_rs_tpu_torch.cli\n"
        "for m in pkgutil.walk_packages(qchem_rs_tpu_torch.__path__, 'qchem_rs_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "print(sorted(k for k in sys.modules if k.startswith('qchem_rs_tpu_torch.')))\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "assert 'qchem_rs_tpu' not in sys.modules, 'the JAX package was imported'\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stderr
    assert "qchem_rs_tpu_torch.ops.eri_kernel" in proc.stdout


def test_no_source_line_imports_jax():
    found = []
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if f.endswith((".py", ".cu")):
                path = os.path.join(dirpath, f)
                with open(path) as fh:
                    found += [f"{path}:{i}" for i, line in enumerate(fh, 1) if "import jax" in line]
    assert found == []
    assert len(list(pkgutil.walk_packages([PKG]))) >= 4
