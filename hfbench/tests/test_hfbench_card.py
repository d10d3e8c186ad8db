"""Each cell on the card, briefly: the run exits 0 and its result is
correct. Skips where there is no card."""

import json
import subprocess
import sys

import pytest

from hfbench.tests.conftest import ROOT

CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_card(cell, cuda_device):
    out = subprocess.run([sys.executable, "-m", "hfbench.run", "--workload", cell, "--seed", "3",
                          "--seconds", "5", "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
                         timeout=1500)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]
