"""A configuration, a traffic mix and a per-layer metric are added by
adding files and entries, with no existing file edited."""

import hashlib
import json
import shutil
from pathlib import Path

from hfbench import run
from hfbench.tests.conftest import ROOT


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_new_cell_and_metric_by_data(tmp_path):
    shutil.copytree(ROOT / "hfbench", tmp_path / "hfbench", ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    before = _digests(tmp_path)

    config = json.loads((ROOT / "hfbench/tests/data/water-sto3g-direct.json").read_text())
    config.update(name="water-sto3g-incore", fock_mode="incore")
    (tmp_path / "hfbench/configs/water-sto3g-incore.json").write_text(json.dumps(config))
    (tmp_path / "hfbench/traffic/cold.json").write_text(json.dumps({"temperature_K": 100, "rotate": False}))
    (tmp_path / "hfbench/metrics/energy_mean_eh.py").write_text(
        "def read(run):\n    done = run.completed()\n"
        "    return sum(j.energy for j in done) / len(done) if done else None\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "water-sto3g-incore", "source": "test", "reduced": [], "why": "test",
                             "file": "hfbench/configs/water-sto3g-incore.json"})
    bench["workloads"].append({"name": "water.cold", "config": "water-sto3g-incore", "traffic": "cold",
                               "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "energy_mean_eh", "unit": "Eh", "better": "lower",
                               "source": "program_counter", "layer": "entry", "moves": "time_to_scf_s",
                               "workloads": ["water.cold"]})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in ("time_to_scf_s", "scf_passes"):
            m["workloads"].append("water.cold")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    traced = run.measure(bench, "water.cold", 17, 1.0, True, device="cpu", root=tmp_path)
    plain = run.measure(bench, "water.cold", 17, 1.0, False, device="cpu", root=tmp_path)
    assert traced["correct"] and plain["correct"]
    assert -76.0 < traced["metrics"]["energy_mean_eh"]["value"] < -74.0
    assert set(plain["metrics"]) == {"time_to_scf_s", "peak_device_gb", "setup_s"}
    assert 0 < traced["metrics"]["scf_passes"]["value"] < 30
    after = _digests(tmp_path)
    assert [p for p, d in before.items() if after[p] != d] == [Path("BENCHMARK.json")]
