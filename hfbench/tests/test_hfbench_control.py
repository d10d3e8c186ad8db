"""The comparison fails what it must: the control (the reference itself in
float32, in the program's place) at the configurations' own limits, and a
run of the harness with the timed path broken underneath."""

import json

import numpy as np
import pytest
import torch

from hfbench import run
from hfbench.judge import reference_at
from hfbench.tests.conftest import ROOT


@pytest.mark.parametrize("config", ["naphthalene-ccpvdz-direct", "naphthalene-ccpvdz-incore"])
def test_control_fails(config):
    cfg = json.loads((ROOT / f"hfbench/configs/{config}.json").read_text())
    water = json.loads((ROOT / "hfbench/tests/data/water-sto3g-direct.json").read_text())
    cfg.update(molecule=water["molecule"], basis=water["basis"])
    x = json.loads((ROOT / water["molecule"]).read_text())
    x = np.array([a["position"] for a in x]) + np.random.default_rng(2).normal(0, 0.05, (3, 3))
    ref = reference_at(cfg, ROOT, x, torch.float64, "cpu")
    sol = ref.solve()
    low = reference_at(cfg, ROOT, x, torch.float32, "cpu").solve()
    gaps = ref.judge(sol, low.energy, low.orbital_energies, low.density)
    assert any(gaps[k] > cfg["limits"][k] for k in gaps), gaps
    same = ref.judge(sol, sol.energy, sol.orbital_energies, sol.density)
    assert all(same[k] <= cfg["limits"][k] for k in same), same


def _state_unchanged(monkeypatch):
    """Every SCF step keeps the density it was given and says it converged."""
    from qchem_rs_tpu_torch.models import rhf, scf

    real = rhf._rhf_scf
    monkeypatch.setattr(rhf, "_rhf_scf", lambda H, X, S, nocc, config, g_fn, D0=None: real(
        H, X, S, nocc, __import__("dataclasses").replace(config, mixing_factor=0.0), g_fn, D0))
    monkeypatch.setattr(scf, "converged_flag", lambda *a, **k: True)


def _half_batch(monkeypatch):
    """The direct pass digests every other batch and doubles the sums."""
    from qchem_rs_tpu_torch.ops.fock_stream import StreamingFockBuilder

    real = StreamingFockBuilder._local_pass

    def half(self, D):
        keep = self.batches, self._offsets
        self.batches, self._offsets = self.batches[::2], self._offsets[::2]
        try:
            Jp, K1 = real(self, D)
        finally:
            self.batches, self._offsets = keep
        return 2.0 * Jp, 2.0 * K1

    monkeypatch.setattr(StreamingFockBuilder, "_local_pass", half)


def _answer_altered(monkeypatch):
    """The entry's energy is altered by 1e-5 Eh where it is produced."""
    from qchem_rs_tpu_torch.models import rhf

    real = rhf.restricted_hartree_fock

    def altered(*a, **k):
        out = real(*a, **k)
        out.electronic_energy += 1e-5
        return out

    monkeypatch.setattr(rhf, "restricted_hartree_fock", altered)


@pytest.mark.parametrize("fault", [None, _state_unchanged, _half_batch, _answer_altered])
def test_harness_sees_faults(fault, monkeypatch, water_bench):
    if fault is not None:
        fault(monkeypatch)
    result = run.measure(water_bench, "water.md17", 2**31 + 5, 1.0, False, device="cpu")
    assert result["correct"] is (fault is None), result["checks"]
