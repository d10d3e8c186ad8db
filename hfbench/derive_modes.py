"""The equilibrium geometry and harmonic modes that a thermal traffic mix
samples about, derived once with the port at a configuration's own level
and kept as data beside the configuration.

    python3 -m hfbench.derive_modes --config hfbench/configs/<name>.json \\
        --start <molecule.json> --molecule <out molecule.json> --modes <out modes.json> [--device cuda]

1. The minimum: the port's ``optimize_geometry`` (L-BFGS-B on analytic
   RHF gradients) at the configuration's molecule, basis, charge,
   screening and Fock mode, with a tighter SCF (``EPSILON``), from
   ``--start``; then averaged over the point group the start has (the
   reflections and two-fold rotations about the centroid's axes), so that
   the optimiser's round-off does not break it.
2. The Hessian: forward differences of the analytic gradient about that
   minimum (step ``STEP`` Bohr), one displaced gradient per Cartesian
   direction of each symmetry-unique atom; the columns of every
   equivalent atom follow from the group. Symmetrised, mass-weighted,
   with translations and rotations projected out, and diagonalised.

``--modes`` gets the minimum, the masses, the 3N - 6 frequencies and the
mass-weighted normal modes (orthonormal columns); ``--molecule`` gets the
minimum in the molecule format, for the configuration's ``molecule``.
``stream.py`` draws classical Boltzmann displacements from them.
"""

from __future__ import annotations

import argparse
import itertools
import json
import sys
import time
from pathlib import Path

import numpy as np

#: most-abundant-isotope masses (amu) of the elements the configurations use
MASS_AMU = {1: 1.00782503, 6: 12.0, 7: 14.00307401, 8: 15.99491462}
AMU_TO_ME = 1822.888486209
AU_TO_CM1 = 219474.6313632
EPSILON = 1e-10
STEP = 5e-3


def point_group(numbers: np.ndarray, x: np.ndarray, tol: float = 1e-4) -> list[tuple[np.ndarray, np.ndarray]]:
    """(diagonal of R, atom permutation p) of every operation R = diag(±1,
    ±1, ±1) about the centroid that maps atom i onto atom p[i] of the same
    element; the identity first."""
    c = x - x.mean(axis=0)
    ops = []
    for signs in itertools.product((1.0, -1.0), repeat=3):
        s = np.array(signs)
        d = np.linalg.norm((c * s)[:, None, :] - c[None, :, :], axis=-1)
        p = d.argmin(axis=1)
        if np.all(d[np.arange(len(x)), p] < tol) and np.array_equal(numbers[p], numbers) \
                and len(set(p.tolist())) == len(x):
            ops.append((s, p))
    return ops


def symmetrize(x: np.ndarray, ops) -> np.ndarray:
    c0 = x.mean(axis=0)
    c = x - c0
    out = np.zeros_like(c)
    for s, p in ops:
        out[p] += c * s
    return out / len(ops) + c0


def hessian(gradient, x0: np.ndarray, ops, step: float = STEP, log=print) -> tuple[np.ndarray, np.ndarray]:
    """(Hessian (3N, 3N), gradient at x0) by forward differences over the
    symmetry-unique atoms; ``gradient(x)`` returns (N, 3)."""
    n = len(x0)
    g0 = gradient(x0)
    H = np.full((3 * n, 3 * n), np.nan)
    for a in range(n):
        if not np.isnan(H[0, 3 * a]):
            continue
        for d in range(3):
            x = x0.copy()
            x[a, d] += step
            t = time.perf_counter()
            col = (gradient(x) - g0) / step
            log(f"  column atom {a} axis {d}: {time.perf_counter() - t:.1f} s")
            for s, p in ops:  # displacing p[a] along s_d e_d: component (p[i], c) is s_c s_d col[i, c]
                H[:, 3 * p[a] + d][(3 * p[:, None] + np.arange(3)).reshape(-1)] = (col * s * s[d]).reshape(-1)
    return 0.5 * (H + H.T), g0


def normal_modes(numbers: np.ndarray, x0: np.ndarray, H: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(masses amu, frequencies cm^-1, mass-weighted modes (3N, 3N - 6))
    of H with translations and rotations projected out."""
    masses = np.array([MASS_AMU[int(z)] for z in numbers])
    sm = np.sqrt(np.repeat(masses * AMU_TO_ME, 3))
    r = x0 - (masses[:, None] * x0).sum(axis=0) / masses.sum()
    rigid = []
    for k in range(3):
        t = np.zeros_like(x0)
        t[:, k] = 1.0
        rigid.append(t)
        rigid.append(np.cross(r, t))
    B = np.stack([v.reshape(-1) for v in rigid], axis=1) * sm[:, None]
    U, _, _ = np.linalg.svd(B, full_matrices=True)
    Q = U[:, 6:]  # the complement of the six rigid motions
    w, v = np.linalg.eigh(Q.T @ (H / sm[:, None] / sm[None, :]) @ Q)
    return masses, np.sign(w) * np.sqrt(np.abs(w)) * AU_TO_CM1, Q @ v


def write_molecule(path, numbers: np.ndarray, x: np.ndarray) -> None:
    Path(path).write_text(json.dumps(
        [{"element": str(int(z)), "position": p.tolist()} for z, p in zip(numbers, x)], indent=1) + "\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--start", required=True)
    ap.add_argument("--molecule", required=True)
    ap.add_argument("--modes", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--gtol", type=float, default=3e-5)
    args = ap.parse_args(argv)

    from qchem_rs_tpu_torch.config import HartreeFockConfig
    from qchem_rs_tpu_torch.models.gradients import scf_and_gradient
    from qchem_rs_tpu_torch.models.optimize import optimize_geometry
    from qchem_rs_tpu_torch.utils.basis import BasisSet
    from qchem_rs_tpu_torch.utils.system import MolecularSystem

    root = Path.cwd()
    config = json.loads(Path(args.config).read_text())
    system = MolecularSystem.load(args.start, BasisSet.load(root / config["basis"]), spherical=config["spherical"])
    settings = HartreeFockConfig(max_iterations=300, epsilon=EPSILON, convergence_metric=config["convergence_metric"],
                                 charge=config["charge"], screening_threshold=config["screening_threshold"],
                                 fock_mode=config["fock_mode"], initial_guess=config["initial_guess"])
    numbers = np.array([a.ordinal for a in system.atoms])
    start = np.asarray(system.positions, dtype=np.float64)
    ops = point_group(numbers, start)
    log = lambda s: print(s, file=sys.stderr, flush=True)  # noqa: E731
    log(f"{len(numbers)} atoms, {len(ops)} symmetry operations")

    t = time.perf_counter()
    opt = optimize_geometry(system, settings, gtol=args.gtol, device=args.device)
    log(f"optimised: {opt.steps} steps, {time.perf_counter() - t:.1f} s, E {opt.energy!r}, max |g| {opt.gradient_norm:.2e}")
    x0 = symmetrize(opt.positions, ops)
    write_molecule(args.molecule, numbers, x0)
    guess = {"density": None}

    def gradient(x):
        out, g = scf_and_gradient(system.with_positions(x), settings, density_guess=guess["density"],
                                  device=args.device)
        guess["density"] = out.density
        return np.asarray(g, dtype=np.float64).reshape(x.shape)

    t = time.perf_counter()
    H, g0 = hessian(gradient, x0, ops, log=log)
    masses, freqs, modes = normal_modes(numbers, x0, H)
    log(f"Hessian: {time.perf_counter() - t:.1f} s; max |g| at the minimum {np.abs(g0).max():.2e}; "
        f"frequencies {freqs[:3].round(1).tolist()} ... {freqs[-3:].round(1).tolist()} cm^-1")
    if freqs[0] <= 0:
        raise SystemExit(f"not a minimum: lowest frequency {freqs[0]:.1f} cm^-1")

    Path(args.modes).write_text(json.dumps({
        "derived_by": "python3 -m hfbench.derive_modes " + " ".join(argv if argv is not None else sys.argv[1:]),
        "level": {k: config[k] for k in ("method", "basis", "spherical", "charge", "screening_threshold",
                                         "fock_mode")} | {"epsilon": EPSILON, "hessian_step_bohr": STEP},
        "start": args.start, "energy": opt.energy, "max_gradient_at_minimum": float(np.abs(g0).max()), "optimiser_steps": opt.steps,
        "numbers": numbers.tolist(), "positions": x0.tolist(), "masses_amu": masses.tolist(),
        "frequencies_cm1": freqs.tolist(), "modes": modes.tolist(),
    }) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
