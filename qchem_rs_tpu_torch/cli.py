"""Command-line interface of the port: the ``rhf``, ``uhf``, ``mp2`` and
``info`` subcommands of ``qchem_rs_tpu/cli.py``.

    python -m qchem_rs_tpu_torch.cli rhf -b data/basis/cc-pVDZ.json \\
        -m data/mol/naphthalene.json --epsilon 1e-8 --fock-mode pair --guess sad
    python -m qchem_rs_tpu_torch.cli uhf -b data/basis/6-31G.json \\
        -m data/mol/hydroxyl.json --spin-multiplicity 2
    python -m qchem_rs_tpu_torch.cli rhf -b data/basis/STO-3G.json \\
        -m data/mol/water.json --dipole --mulliken --field 0 0 0.001
    python -m qchem_rs_tpu_torch.cli mp2 -b data/basis/cc-pVDZ.json \\
        -m data/mol/water.json --epsilon 1e-10 --frozen-core auto
    python -m qchem_rs_tpu_torch.cli info -b data/basis/6-31G.json -m data/mol/methane.json

Every SCF subcommand takes the JAX CLI's common flags (``--charge``,
``--mixing``, ``--level-shift``, ``--field``, ``--checkpoint``,
``--resume``, ``--dipole``, ``--mulliken``, ``--trace-dir``, ...) and the
top-level ``--verbose``, and prints its lines character for character
(the reference CLI's main.rs:98-106 and 143-152 format, and the JAX CLI's
<S^2>, property and MP2 lines). ``--trace-dir`` writes a torch.profiler
Chrome trace. ``--device`` defaults to ``cuda``; when CUDA is missing the
command exits with a one-line error rather than falling back to the CPU.
Non-convergence exits 1.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import sys
import time

CONVERGENCE_METRICS = ("diag_rms", "full_rms", "energy", "diis_err",
                       "diag_rms2", "full_rms2", "diis_err2")


class CliError(Exception):
    """User-facing error, printed as one line."""


def _convergence_metric(value: str) -> str:
    if value in CONVERGENCE_METRICS or value == "composite":
        return value
    if value.startswith("composite:"):
        try:
            float(value.split(":", 1)[1])
        except ValueError:
            raise argparse.ArgumentTypeError(
                f"bad composite guard in {value!r} (want composite:<float>)") from None
        return value
    raise argparse.ArgumentTypeError(
        f"unknown convergence metric {value!r} ({', '.join(CONVERGENCE_METRICS)}, "
        "composite[:GUARD])"
    )


def _fmt_orbitals(w) -> str:
    return "[" + ", ".join(f"{x:.3f}" for x in w) + "]"


def _device(name: str):
    import torch

    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise CliError(f"device {name!r} requested but CUDA is not available")
    return device


def _system(args, spherical: bool):
    from qchem_rs_tpu_torch import BasisSet, MolecularSystem

    try:
        basis = BasisSet.load(args.basis_set)
    except (OSError, ValueError, KeyError) as e:
        raise CliError(f"cannot load basis set {args.basis_set!r}: {e}") from e
    try:
        return MolecularSystem.load(args.molecule, basis, spherical=spherical)
    except (OSError, ValueError, KeyError) as e:
        raise CliError(f"cannot load molecule {args.molecule!r}: {e}") from e


def _build(args):
    """(system, config, device) of an SCF subcommand's arguments, or a
    CliError."""
    from qchem_rs_tpu_torch import HartreeFockConfig

    device = _device(args.device)
    system = _system(args, args.spherical)
    cfg = HartreeFockConfig(
        max_iterations=args.max_iterations,
        epsilon=args.epsilon,
        charge=args.charge,
        spin_multiplicity=getattr(args, "spin_multiplicity", 0) or 0,
        convergence_metric=args.convergence,
        mixing_factor=args.mixing,
        verbose=args.verbose,
        screening_threshold=args.screening_threshold,
        fock_mode=args.fock_mode,
        level_shift=args.level_shift,
        electric_field=tuple(args.field or (0.0, 0.0, 0.0)),
        initial_guess=args.guess,
    )
    return system, cfg, device


def _resume_guess(args, kind: str):
    """A --resume checkpoint's density, the warm-start guess."""
    if not args.resume:
        return None
    from qchem_rs_tpu_torch.utils.checkpoint import ScfCheckpoint

    try:
        ck = ScfCheckpoint.load(args.resume)
    except OSError as e:
        raise CliError(f"cannot load checkpoint {args.resume!r}: {e}") from e
    if ck.kind != kind:
        raise CliError(f"checkpoint {args.resume!r} is kind={ck.kind!r}, expected {kind!r}")
    return ck.density


def _print_energies(out, elapsed: float) -> None:
    print(f"hartree fock converged after {out.iterations} iterations and {elapsed:0.2f}s")
    print(f"electronic energy: {out.electronic_energy:3.3f}")
    print(f"nuclear repulsion energy: {out.nuclear_repulsion:3.3f}")
    print(f"hartree fock energy: {out.total_energy():3.3f}")


def _print_properties(args, system, total_density, device) -> None:
    if args.dipole:
        from qchem_rs_tpu_torch.models.properties import AU_TO_DEBYE, dipole_moment

        mu = dipole_moment(system, total_density, device)
        d = float((mu**2).sum() ** 0.5)
        print(
            f"dipole moment (a.u.): [{mu[0]: .6f}, {mu[1]: .6f}, {mu[2]: .6f}]"
            f"  |mu| = {d:.6f} a.u. = {d * AU_TO_DEBYE:.4f} D"
        )
    if args.mulliken:
        from qchem_rs_tpu_torch.models.properties import mulliken_charges

        q = mulliken_charges(system, total_density, device)
        print("mulliken charges:")
        for atom, qi in zip(system.atoms, q):
            print(f"  {atom.ordinal:3d}  {qi: .6f}")


def cmd_rhf(args) -> int:
    from qchem_rs_tpu_torch import restricted_hartree_fock
    from qchem_rs_tpu_torch.utils.profiling import trace

    system, cfg, device = _build(args)
    if cfg.spin_multiplicity == 0:
        cfg = dataclasses.replace(cfg, spin_multiplicity=1)
    guess = _resume_guess(args, "rhf")
    start = time.perf_counter()
    with trace(args.trace_dir):
        out = restricted_hartree_fock(system, cfg, density_guess=guess, device=device)
    elapsed = time.perf_counter() - start
    if args.checkpoint:
        from qchem_rs_tpu_torch.utils.checkpoint import from_rhf_output

        from_rhf_output(out, system).save(args.checkpoint)
    if not out.converged:
        print("hartree fock did not converge", file=sys.stderr)
        return 1
    _print_energies(out, elapsed)
    print(f"orbital energies: {_fmt_orbitals(out.orbital_energies)}")
    _print_properties(args, system, out.density, device)
    return 0


def cmd_uhf(args) -> int:
    from qchem_rs_tpu_torch import unrestricted_hartree_fock
    from qchem_rs_tpu_torch.models import scf
    from qchem_rs_tpu_torch.models.properties import spin_expectation
    from qchem_rs_tpu_torch.utils.profiling import trace

    system, cfg, device = _build(args)
    guess = _resume_guess(args, "uhf")
    start = time.perf_counter()
    with trace(args.trace_dir):
        out = unrestricted_hartree_fock(system, cfg, density_guess=guess, device=device)
    elapsed = time.perf_counter() - start
    if args.checkpoint:
        from qchem_rs_tpu_torch.utils.checkpoint import from_uhf_output

        from_uhf_output(out, system).save(args.checkpoint)
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
    _print_properties(args, system, out.density[0] + out.density[1], device)
    return 0


def cmd_mp2(args) -> int:
    from qchem_rs_tpu_torch.models.mp2 import mp2, mp2_pair_space, ump2, ump2_pair_space

    system, cfg, device = _build(args)
    open_shell = cfg.spin_multiplicity not in (0, 1) or system.n_electrons(cfg.charge) % 2 == 1
    if cfg.spin_multiplicity == 0 and not open_shell:
        cfg = dataclasses.replace(cfg, spin_multiplicity=1)
    if open_shell:
        fn = ump2_pair_space if cfg.fock_mode == "pair" else ump2
    else:
        # --fock-mode pair runs the transform without an n^4 tensor too
        fn = mp2_pair_space if cfg.fock_mode == "pair" else mp2
    frozen = args.frozen_core if args.frozen_core == "auto" else int(args.frozen_core)
    start = time.perf_counter()
    try:
        res = fn(system, cfg, frozen=frozen, device=device)
    except (RuntimeError, ValueError) as e:
        print(str(e), file=sys.stderr)
        return 1
    elapsed = time.perf_counter() - start
    kind = "ump2" if open_shell else "mp2"
    print(f"{kind} finished after {res.iterations} SCF iterations and {elapsed:0.2f}s")
    print(f"hartree fock energy: {res.scf_total_energy:3.6f}")
    print(f"mp2 correlation energy: {res.correlation_energy:3.6f}")
    print(f"mp2 total energy: {res.total_energy():3.6f}")
    return 0


def cmd_info(args) -> int:
    system = _system(args, spherical=False)
    print(f"MolecularSystem({len(system.atoms)} atoms, {len(system.shells)} shells, "
          f"{system.n_basis()} AOs, basis={system.basis.name!r})")
    print(f"electrons: {system.n_electrons()}")
    print(f"nuclear repulsion: {system.nuclear_repulsion():.10f}")
    for l, cls in system.shell_classes.items():
        print(f"  l={l}: {cls.nshells} shells, contraction padded to K={cls.K}")
    return 0


def _common_flags(p: argparse.ArgumentParser, uhf: bool) -> None:
    """The common flags of ``qchem_rs_tpu/cli.py`` that the port runs, and
    ``--device``."""
    p.add_argument("--basis-set", "-b", required=True, help="basis set JSON (MolSSI BSE schema)")
    p.add_argument("--molecule", "-m", required=True, help="molecule JSON (positions in Bohr)")
    p.add_argument("--max-iterations", type=int, default=100, help="SCF iteration cap (default 100)")
    p.add_argument("--epsilon", type=float, default=1e-6,
                   help="convergence threshold (default 1e-6)")
    p.add_argument("--charge", "-c", type=int, default=0, help="total molecular charge")
    if uhf:
        p.add_argument("--spin-multiplicity", "-s", type=int, default=0,
                       help="2S+1; 0 = reference-compatible n/2-n/2 split")
    p.add_argument("--convergence", type=_convergence_metric, default="diag_rms",
                   help="convergence metric: diag_rms (reference quirk), full_rms, energy, "
                   "diis_err, composite[:GUARD]; a trailing 2 needs two passes below epsilon")
    p.add_argument("--guess", choices=["huckel", "sad"], default="huckel",
                   help="initial density: huckel (rhf.rs:133-150) or sad (superposition of "
                   "atomic densities)")
    p.add_argument("--mixing", type=float, default=1.0,
                   help="density mixing factor (1.0 = no damping)")
    p.add_argument("--spherical", action="store_true",
                   help="use real solid-harmonic (5d/7f) basis functions instead of Cartesian")
    p.add_argument("--screening-threshold", type=float, default=1e-12,
                   help="Schwarz screening threshold for pair tiles (0 disables)")
    p.add_argument("--fock-mode", choices=["incore", "pair", "direct"], default="incore",
                   help="incore materializes the ERI operator once; pair keeps only the "
                   "pair-space matrices (J and K as matvecs); direct recomputes the screened "
                   "integrals at every pass")
    p.add_argument("--level-shift", type=float, default=0.0,
                   help="virtual-orbital level shift in Hartree (0 disables)")
    p.add_argument("--trace-dir", default=None,
                   help="write a torch.profiler Chrome trace of the run to this directory")
    p.add_argument("--checkpoint", default=None,
                   help="write the converged SCF state to this .npz path")
    p.add_argument("--dipole", action="store_true",
                   help="print the electric dipole moment from the converged density")
    p.add_argument("--mulliken", action="store_true",
                   help="print Mulliken atomic partial charges")
    p.add_argument("--field", type=float, nargs=3, default=None, metavar=("FX", "FY", "FZ"),
                   help="uniform external electric field in atomic units")
    p.add_argument("--resume", default=None,
                   help="warm-start from an .npz checkpoint written by --checkpoint (by "
                   "either package)")
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="qchem_rs_tpu_torch",
        description="Hartree-Fock and MP2 on PyTorch + CUDA (port of qchem_rs_tpu)",
    )
    parser.add_argument("--verbose", "-v", action="store_true", help="per-iteration SCF logging")
    sub = parser.add_subparsers(dest="command", required=True)
    p = sub.add_parser("rhf", help="restricted Hartree-Fock single point")
    _common_flags(p, uhf=False)
    p.set_defaults(fn=cmd_rhf)
    p = sub.add_parser("uhf", help="unrestricted Hartree-Fock single point")
    _common_flags(p, uhf=True)
    p.set_defaults(fn=cmd_uhf)
    p = sub.add_parser("mp2", help="MP2 correlation energy (restricted; spin-unrestricted UMP2 "
                       "for open shells)")
    _common_flags(p, uhf=True)
    p.add_argument("--frozen-core", default="0", metavar="N|auto",
                   help="core spatial orbitals excluded from correlation: an integer or 'auto' "
                   "(1s for Li-Ne, 1s2s2p for Na-Ar)")
    p.set_defaults(fn=cmd_mp2)
    p = sub.add_parser("info", help="inspect a molecule/basis combination")
    p.add_argument("--basis-set", "-b", required=True)
    p.add_argument("--molecule", "-m", required=True)
    p.set_defaults(fn=cmd_info)
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO if args.verbose else logging.WARNING,
                        format="%(levelname)s %(name)s: %(message)s")
    try:
        return args.fn(args)
    except CliError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
