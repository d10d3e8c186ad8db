"""The comparison that decides ``correct``.

Every job of the window must have returned and converged. From the jobs
that did, ``check_jobs`` are drawn from the seed, the one with the most
SCF passes always among them, and each is judged against the plain
reference (``reference/scf.py``) at the very geometry the program was
given: the reference builds its own integrals there, converges its own
RHF in float64, and reads the program's energy, orbital energies and
density only to judge them. Each number compared is the worst over the
judged jobs, held to the configuration's ``limits``.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from hfbench import stream
from hfbench.reference.molecule import Molecule, read_basis, read_molecule
from hfbench.reference.scf import Reference

GAPS = ("energy_gap", "orbital_gap", "commutator")


def sample(jobs: list, k: int, seed: int) -> list:
    """The job with the most passes and k - 1 others drawn from the seed."""
    if not jobs:
        return []
    first = max(range(len(jobs)), key=lambda i: jobs[i].passes)
    rest = [i for i in range(len(jobs)) if i != first]
    picked = stream.rng(seed, stream.CHECK).choice(rest, size=min(k - 1, len(rest)), replace=False)
    return [jobs[first]] + [jobs[i] for i in sorted(picked)]


def reference_at(config: dict, root: Path, positions: np.ndarray, dtype, device) -> Reference:
    numbers, _ = read_molecule(root / config["molecule"])
    mol = Molecule(numbers, positions, read_basis(root / config["basis"]))
    return Reference(mol, config["screening_threshold"], dtype=dtype, device=device, charge=config["charge"])


def judge(config: dict, root: Path, jobs: list, seed: int, device) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}) of a run's window."""
    import torch

    done = [j for j in jobs if j.error is None and j.converged]
    checks = {
        "errors": sum(j.error is not None for j in jobs),
        "unconverged": sum(j.error is None and not j.converged for j in jobs),
        "reference_unconverged": 0,
    }
    gaps = {name: [0.0] for name in GAPS}
    picked = sample(done, config["check_jobs"], seed)
    for job in picked:
        ref = reference_at(config, root, job.positions, torch.float64, device)
        sol = ref.solve()
        checks["reference_unconverged"] += int(not sol.converged)
        for name, value in ref.judge(sol, job.energy, job.orbital_energies, job.density).items():
            gaps[name].append(value)
        del ref
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    limits = {name: 0 for name in checks} | {name: config["limits"][name] for name in GAPS}
    checks |= {name: float(np.max(v)) for name, v in gaps.items()}  # a NaN stays NaN and fails
    table = {name: {"value": checks[name], "limit": limits[name]} for name in checks}
    return all(v["value"] <= v["limit"] for v in table.values()), table
