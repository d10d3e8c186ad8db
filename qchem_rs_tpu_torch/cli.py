"""Command-line interface of the port: the ``rhf`` and ``uhf`` subcommands.

    python -m qchem_rs_tpu_torch.cli rhf -b data/basis/cc-pVDZ.json \\
        -m data/mol/naphthalene.json --epsilon 1e-8 --fock-mode pair --guess sad
    python -m qchem_rs_tpu_torch.cli uhf -b data/basis/6-31G.json \\
        -m data/mol/hydroxyl.json --spin-multiplicity 2
    python -m qchem_rs_tpu_torch.cli rhf -b data/basis/cc-pVDZ.json \\
        -m data/mol/water.json --spherical

Prints the lines of ``qchem_rs_tpu/cli.py`` (the reference CLI's
main.rs:98-106 and 143-152 format, and the JAX CLI's <S^2> line for UHF).
``--device`` defaults to ``cuda``; when CUDA is missing the command exits
with a one-line error rather than falling back to the CPU.
Non-convergence exits 1.
"""

from __future__ import annotations

import argparse
import sys
import time

CONVERGENCE_METRICS = ("diag_rms", "full_rms", "energy", "diis_err",
                       "diag_rms2", "full_rms2", "diis_err2")


class CliError(Exception):
    """User-facing error, printed as one line."""


def _convergence_metric(value: str) -> str:
    if value in CONVERGENCE_METRICS or value == "composite" or value.startswith("composite:"):
        return value
    raise argparse.ArgumentTypeError(
        f"unknown convergence metric {value!r} ({', '.join(CONVERGENCE_METRICS)}, "
        "composite[:GUARD])"
    )


def _fmt_orbitals(w) -> str:
    return "[" + ", ".join(f"{x:.3f}" for x in w) + "]"


def _load(args):
    """(system, device) of the command's arguments, or a CliError."""
    import torch

    from qchem_rs_tpu_torch import BasisSet, MolecularSystem

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise CliError(f"device {args.device!r} requested but CUDA is not available")
    try:
        basis = BasisSet.load(args.basis_set)
    except (OSError, ValueError, KeyError) as e:
        raise CliError(f"cannot load basis set {args.basis_set!r}: {e}") from e
    try:
        system = MolecularSystem.load(args.molecule, basis, spherical=args.spherical)
    except (OSError, ValueError, KeyError) as e:
        raise CliError(f"cannot load molecule {args.molecule!r}: {e}") from e
    return system, device


def _config(args, **kw):
    from qchem_rs_tpu_torch import HartreeFockConfig

    return HartreeFockConfig(
        max_iterations=args.max_iterations,
        epsilon=args.epsilon,
        convergence_metric=args.convergence,
        screening_threshold=args.screening_threshold,
        fock_mode=args.fock_mode,
        initial_guess=args.guess,
        **kw,
    )


def _print_energies(out, elapsed: float) -> None:
    print(f"hartree fock converged after {out.iterations} iterations and {elapsed:0.2f}s")
    print(f"electronic energy: {out.electronic_energy:3.3f}")
    print(f"nuclear repulsion energy: {out.nuclear_repulsion:3.3f}")
    print(f"hartree fock energy: {out.total_energy():3.3f}")


def cmd_rhf(args) -> int:
    from qchem_rs_tpu_torch import restricted_hartree_fock

    system, device = _load(args)
    cfg = _config(args, spin_multiplicity=1)
    start = time.perf_counter()
    out = restricted_hartree_fock(system, cfg, device=device)
    elapsed = time.perf_counter() - start
    if not out.converged:
        print("hartree fock did not converge", file=sys.stderr)
        return 1
    _print_energies(out, elapsed)
    print(f"orbital energies: {_fmt_orbitals(out.orbital_energies)}")
    return 0


def cmd_uhf(args) -> int:
    from qchem_rs_tpu_torch import unrestricted_hartree_fock
    from qchem_rs_tpu_torch.models import scf
    from qchem_rs_tpu_torch.models.uhf import spin_expectation

    system, device = _load(args)
    cfg = _config(args, charge=args.charge, spin_multiplicity=args.spin_multiplicity)
    start = time.perf_counter()
    out = unrestricted_hartree_fock(system, cfg, device=device)
    elapsed = time.perf_counter() - start
    if not out.converged:
        print("hartree fock did not converge", file=sys.stderr)
        return 1
    _print_energies(out, elapsed)
    print(f"orbital energies alpha spin:   {_fmt_orbitals(out.orbital_energies_alpha)}")
    print(f"orbital energies beta spin: {_fmt_orbitals(out.orbital_energies_beta)}")
    na, nb = scf.electron_counts(system.n_electrons(cfg.charge), cfg.spin_multiplicity)
    s2, excess = spin_expectation(system, out.coefficients, na, nb)
    print(f"spin expectation <S^2>: {s2:.4f} "
          f"(exact {s2 - excess:.4f}, contamination {excess:+.4f})")
    return 0


def _add_flags(p: argparse.ArgumentParser, uhf: bool) -> None:
    """The flags of ``qchem_rs_tpu/cli.py`` that the port runs, and
    ``--device``."""
    p.add_argument("--basis-set", "-b", required=True, help="basis set JSON (MolSSI BSE schema)")
    p.add_argument("--molecule", "-m", required=True, help="molecule JSON (positions in Bohr)")
    p.add_argument("--max-iterations", type=int, default=100, help="SCF iteration cap (default 100)")
    p.add_argument("--epsilon", type=float, default=1e-6,
                   help="convergence threshold (default 1e-6)")
    if uhf:
        p.add_argument("--charge", "-c", type=int, default=0, help="total molecular charge")
        p.add_argument("--spin-multiplicity", "-s", type=int, default=0,
                       help="2S+1; 0 = reference-compatible n/2-n/2 split")
    p.add_argument("--convergence", type=_convergence_metric, default="diag_rms",
                   help="convergence metric: diag_rms (reference quirk), full_rms, energy, "
                   "diis_err, composite[:GUARD]; a trailing 2 needs two passes below epsilon")
    p.add_argument("--guess", choices=["huckel", "sad"], default="huckel",
                   help="initial density: huckel (rhf.rs:133-150) or sad (superposition of "
                   "atomic densities)")
    p.add_argument("--spherical", action="store_true",
                   help="use real solid-harmonic (5d/7f) basis functions instead of Cartesian")
    p.add_argument("--screening-threshold", type=float, default=1e-12,
                   help="Schwarz screening threshold for pair tiles (0 disables)")
    p.add_argument("--fock-mode", choices=["incore", "pair", "direct"], default="incore",
                   help="incore materializes the ERI operator once; pair keeps only the "
                   "pair-space matrices (J and K as matvecs); direct recomputes the screened "
                   "integrals at every pass")
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="qchem_rs_tpu_torch",
        description="Hartree-Fock on PyTorch + CUDA (port of qchem_rs_tpu)",
    )
    sub = parser.add_subparsers(dest="command", required=True)
    p = sub.add_parser("rhf", help="restricted Hartree-Fock single point")
    _add_flags(p, uhf=False)
    p.set_defaults(fn=cmd_rhf)
    p = sub.add_parser("uhf", help="unrestricted Hartree-Fock single point")
    _add_flags(p, uhf=True)
    p.set_defaults(fn=cmd_uhf)
    args = parser.parse_args(argv)
    try:
        return args.fn(args)
    except CliError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
