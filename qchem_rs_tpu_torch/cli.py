"""Command-line interface of the port: the ``rhf`` subcommand.

    python -m qchem_rs_tpu_torch.cli rhf -b data/basis/cc-pVDZ.json \\
        -m data/mol/benzene.json --epsilon 1e-8

Prints the five lines of ``qchem_rs_tpu/cli.py`` (the reference CLI's
main.rs:98-106 format). ``--device`` defaults to ``cuda``; when CUDA is
missing the command exits with a one-line error rather than falling back to
the CPU. Non-convergence exits 1.
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


def cmd_rhf(args) -> int:
    import torch

    from qchem_rs_tpu_torch import BasisSet, HartreeFockConfig, MolecularSystem, restricted_hartree_fock

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise CliError(f"device {args.device!r} requested but CUDA is not available")
    try:
        basis = BasisSet.load(args.basis_set)
    except (OSError, ValueError, KeyError) as e:
        raise CliError(f"cannot load basis set {args.basis_set!r}: {e}") from e
    try:
        system = MolecularSystem.load(args.molecule, basis)
    except (OSError, ValueError, KeyError) as e:
        raise CliError(f"cannot load molecule {args.molecule!r}: {e}") from e
    cfg = HartreeFockConfig(
        max_iterations=args.max_iterations,
        epsilon=args.epsilon,
        convergence_metric=args.convergence,
        spin_multiplicity=1,
    )
    start = time.perf_counter()
    out = restricted_hartree_fock(system, cfg, device=device)
    elapsed = time.perf_counter() - start
    if not out.converged:
        print("hartree fock did not converge", file=sys.stderr)
        return 1
    print(f"hartree fock converged after {out.iterations} iterations and {elapsed:0.2f}s")
    print(f"electronic energy: {out.electronic_energy:3.3f}")
    print(f"nuclear repulsion energy: {out.nuclear_repulsion:3.3f}")
    print(f"hartree fock energy: {out.total_energy():3.3f}")
    print(f"orbital energies: {_fmt_orbitals(out.orbital_energies)}")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="qchem_rs_tpu_torch",
        description="Hartree-Fock on PyTorch + CUDA (port of qchem_rs_tpu)",
    )
    sub = parser.add_subparsers(dest="command", required=True)
    p = sub.add_parser("rhf", help="restricted Hartree-Fock single point (in-core)")
    p.add_argument("--basis-set", "-b", required=True, help="basis set JSON (MolSSI BSE schema)")
    p.add_argument("--molecule", "-m", required=True, help="molecule JSON (positions in Bohr)")
    p.add_argument("--max-iterations", type=int, default=100, help="SCF iteration cap (default 100)")
    p.add_argument("--epsilon", type=float, default=1e-6,
                   help="convergence threshold (default 1e-6)")
    p.add_argument("--convergence", type=_convergence_metric, default="diag_rms",
                   help="convergence metric: diag_rms (reference quirk), full_rms, energy, "
                   "diis_err, composite[:GUARD]; a trailing 2 needs two passes below epsilon")
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    p.set_defaults(fn=cmd_rhf)
    args = parser.parse_args(argv)
    try:
        return args.fn(args)
    except CliError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
