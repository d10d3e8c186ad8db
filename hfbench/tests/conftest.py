"""CPU tests of the benchmark. They use the port on the CPU (``device="cpu"``)
and the small water/STO-3G configuration under ``tests/data``."""

import json
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
DATA = Path(__file__).resolve().parent / "data"


@pytest.fixture(autouse=True)
def small_torch(monkeypatch, tmp_path):
    """One intra-op thread, and the SAD cache in a fresh directory."""
    monkeypatch.setenv("QCHEM_TORCH_SAD_CACHE", str(tmp_path / "sad"))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def water_bench():
    """BENCHMARK.json with a water/STO-3G cell, ``water.md17``, added."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "water-sto3g-direct", "source": "test", "reduced": [], "why": "test",
                             "file": "hfbench/tests/data/water-sto3g-direct.json"})
    bench["workloads"].append({"name": "water.md17", "config": "water-sto3g-direct", "traffic": "md17",
                               "chips": 1, "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"].append("water.md17")
    return bench


@pytest.fixture
def cuda_device():
    """Skips where there is no card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return "cuda"
