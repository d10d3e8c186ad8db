"""Command-line interface of the port: the ``rhf`` (with ``--gradient``
and ``--polarizability``), ``uhf``, ``mp2``, ``ccsd``, ``fci``, ``eom``,
``cis``, ``optimize``, ``frequencies``, ``sweep`` and ``info``
subcommands of ``qchem_rs_tpu/cli.py``.

    python -m qchem_rs_tpu_torch.cli rhf -b data/basis/cc-pVDZ.json \\
        -m data/mol/naphthalene.json --epsilon 1e-8 --fock-mode pair --guess sad
    python -m qchem_rs_tpu_torch.cli uhf -b data/basis/6-31G.json \\
        -m data/mol/hydroxyl.json --spin-multiplicity 2
    python -m qchem_rs_tpu_torch.cli rhf -b data/basis/STO-3G.json \\
        -m data/mol/water.json --dipole --mulliken --field 0 0 0.001
    python -m qchem_rs_tpu_torch.cli mp2 -b data/basis/cc-pVDZ.json \\
        -m data/mol/water.json --epsilon 1e-10 --frozen-core auto
    python -m qchem_rs_tpu_torch.cli ccsd -b data/basis/cc-pVDZ.json \\
        -m data/mol/water.json --epsilon 1e-10 --triples
    python -m qchem_rs_tpu_torch.cli cis -b data/basis/cc-pVDZ.json \\
        -m data/mol/naphthalene.json --fock-mode pair --nstates 5
    python -m qchem_rs_tpu_torch.cli eom -b data/basis/STO-3G.json \\
        -m data/mol/water.json --matrix-free --formulation spatial
    python -m qchem_rs_tpu_torch.cli rhf -b data/basis/cc-pVDZ.json \\
        -m data/mol/water.json --epsilon 1e-10 --gradient --polarizability
    python -m qchem_rs_tpu_torch.cli frequencies -b data/basis/cc-pVDZ.json \\
        -m data/mol/water.json --epsilon 1e-10 --opt-first --thermo
    python -m qchem_rs_tpu_torch.cli info -b data/basis/6-31G.json -m data/mol/methane.json
    torchrun --nproc_per_node=4 -m qchem_rs_tpu_torch.cli sweep -b data/basis/cc-pVDZ.json \\
        -m data/mol/benzene.json -g conformers.json --epsilon 1e-8

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
    if value.startswith("espan"):
        from qchem_rs_tpu_torch.models.scf import espan_params

        try:
            espan_params(value)
        except (ValueError, IndexError) as e:
            raise argparse.ArgumentTypeError(
                f"bad espan metric {value!r} (want espan:<window>[:<guard>]): {e}") from None
        return value
    raise argparse.ArgumentTypeError(
        f"unknown convergence metric {value!r} ({', '.join(CONVERGENCE_METRICS)}, "
        "composite[:GUARD], espan:<W>[:<GUARD>])"
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
    if args.gradient:
        from qchem_rs_tpu_torch.models.gradients import rhf_gradient

        g = rhf_gradient(system, cfg, output=out, device=device)
        print("nuclear gradient (Hartree/Bohr):")
        for atom, row in zip(system.atoms, g):
            print(f"  {atom.ordinal:3d}  {row[0]: .8f} {row[1]: .8f} {row[2]: .8f}")
    if args.polarizability:
        import numpy as np

        from qchem_rs_tpu_torch.models.response import static_polarizability

        alpha = static_polarizability(system, cfg, output=out, device=device)
        iso = float(np.trace(alpha) / 3.0)
        print(f"static polarizability (a.u.), isotropic {iso:.6f}:")
        for row in alpha:
            print(f"  {row[0]: .6f} {row[1]: .6f} {row[2]: .6f}")
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


def _open_shell(system, cfg) -> bool:
    return cfg.spin_multiplicity not in (0, 1) or system.n_electrons(cfg.charge) % 2 == 1


def _print_vector(label: str, mu, tail: str) -> None:
    print(f"{label} [{mu[0]: .6f}, {mu[1]: .6f}, {mu[2]: .6f}]  {tail}")


def cmd_ccsd(args) -> int:
    import numpy as np

    from qchem_rs_tpu_torch.models.cc import ccsd

    system, cfg, device = _build(args)
    open_shell = _open_shell(system, cfg)
    if cfg.spin_multiplicity == 0 and not open_shell:
        cfg = dataclasses.replace(cfg, spin_multiplicity=1)
    frozen = args.frozen_core if args.frozen_core == "auto" else int(args.frozen_core)
    start = time.perf_counter()
    try:
        res = ccsd(system, cfg, frozen=frozen, triples=args.triples, cc_epsilon=args.cc_epsilon,
                   device=device)
    except (RuntimeError, ValueError) as e:
        print(str(e), file=sys.stderr)
        return 1
    elapsed = time.perf_counter() - start
    if not res.converged:
        print("ccsd amplitudes did not converge", file=sys.stderr)
        return 1
    kind = "uccsd" if open_shell else "ccsd"
    print(f"{kind} converged after {res.iterations} CC iterations "
          f"({res.scf_iterations} SCF) and {elapsed:0.2f}s")
    print(f"hartree fock energy: {res.scf_total_energy:3.6f}")
    print(f"mp2 correlation energy: {res.mp2_correlation_energy:3.6f}")
    print(f"ccsd correlation energy: {res.correlation_energy:3.6f}")
    if res.triples_correction is not None:
        print(f"(t) correction: {res.triples_correction:3.6f}")
    print(f"{kind} total energy: {res.total_energy():3.6f}")
    if args.dipole and not open_shell:
        if args.relaxed:
            from qchem_rs_tpu_torch.models.cc_relaxed import ccsd_relaxed_dipole

            p = ccsd_relaxed_dipole(system, cfg, cc_epsilon=args.cc_epsilon, device=device)
            d, du = float(np.linalg.norm(p.ccsd_dipole)), float(np.linalg.norm(p.ccsd_dipole_unrelaxed))
            _print_vector("ccsd dipole (relaxed, a.u.):", p.ccsd_dipole,
                          f"|mu| = {d:.6f} (unrelaxed {du:.6f})")
        else:
            from qchem_rs_tpu_torch.models.cc_lambda import ccsd_dipole

            p = ccsd_dipole(system, cfg, cc_epsilon=args.cc_epsilon, device=device)
            d, ds = float(np.linalg.norm(p.ccsd_dipole)), float(np.linalg.norm(p.scf_dipole))
            _print_vector("ccsd dipole (unrelaxed, a.u.):", p.ccsd_dipole,
                          f"|mu| = {d:.6f} (scf {ds:.6f})")
    return 0


def cmd_fci(args) -> int:
    from qchem_rs_tpu_torch.models.fci import fci

    system, cfg, device = _build(args)
    if cfg.spin_multiplicity == 0:
        mult = 2 if system.n_electrons(cfg.charge) % 2 else 1
        cfg = dataclasses.replace(cfg, spin_multiplicity=mult)
    start = time.perf_counter()
    try:
        res = fci(system, cfg, nroots=args.nroots, max_dim=args.max_dim, orbitals=args.orbitals,
                  device=device)
    except (RuntimeError, ValueError) as e:
        print(str(e), file=sys.stderr)
        return 1
    elapsed = time.perf_counter() - start
    print(f"fci solved: {res.dimension} determinants ({res.n_alpha}a, {res.n_beta}b) "
          f"in {elapsed:0.2f}s")
    if res.scf_total_energy is not None:
        print(f"hartree fock energy: {res.scf_total_energy:3.6f}")
        print(f"fci correlation energy: {res.correlation_energy():3.6f}")
    for k, e in enumerate(res.total_energies):
        print(f"fci root {k} total energy: {e:3.6f}")
    return 0


def _print_states(energies, strengths=None) -> None:
    from qchem_rs_tpu_torch.models.eom import HARTREE_TO_EV

    for i, w in enumerate(energies, start=1):
        line = f"state {i}: {w:0.6f} Eh  {w * HARTREE_TO_EV:8.4f} eV"
        print(line if strengths is None else f"{line}  f = {strengths[i - 1]:0.6f}")


def cmd_eom(args) -> int:
    from qchem_rs_tpu_torch.models import eom

    system, cfg, device = _build(args)
    if cfg.spin_multiplicity == 0:
        cfg = dataclasses.replace(cfg, spin_multiplicity=1)
    start = time.perf_counter()
    try:
        if args.ip or args.ea:
            fn = eom.ip_eom_ccsd if args.ip else eom.ea_eom_ccsd
            res = fn(system, cfg, nstates=args.nstates, max_dim=args.max_dim, device=device)
            elapsed = time.perf_counter() - start
            label = "ionization potentials" if args.ip else "electron affinities"
            print(f"{res.kind}-eom-ccsd finished in {elapsed:0.2f}s ({res.dimension} determinants)")
            print(f"ccsd total energy: {res.ccsd_total_energy:3.6f}")
            print(f"koopmans estimate: {res.koopmans:0.6f} Eh  "
                  f"{res.koopmans * eom.HARTREE_TO_EV:8.4f} eV")
            print(f"{label}:")
            _print_states(res.energies)
            return 0
        if args.oscillator_strengths:
            if args.matrix_free:
                res = eom.eom_ccsd_transition_moments(system, cfg, nstates=args.nstates,
                                                      device=device)
                what = f"amplitude space {res.dimension}"
            else:
                res = eom.eom_ccsd_properties(system, cfg, nstates=args.nstates,
                                              max_dim=args.max_dim, device=device)
                what = f"{res.dimension} determinants"
            elapsed = time.perf_counter() - start
            print(f"eom-ccsd properties finished in {elapsed:0.2f}s ({what})")
            print(f"hartree fock energy: {res.scf_total_energy:3.6f}")
            print(f"ccsd total energy: {res.ccsd_total_energy:3.6f}")
            gs = res.ground_state_dipole
            print(f"ccsd dipole moment (a.u.): [{gs[0]:0.6f}, {gs[1]:0.6f}, {gs[2]:0.6f}]")
            _print_states(res.excitation_energies, res.oscillator_strengths)
            return 0
        if args.matrix_free:
            res = eom.eom_ccsd_davidson(system, cfg, nstates=args.nstates,
                                        formulation=args.formulation, device=device)
        else:
            res = eom.eom_ccsd(system, cfg, nstates=args.nstates, max_dim=args.max_dim,
                               device=device)
    except (RuntimeError, ValueError) as e:
        print(str(e), file=sys.stderr)
        return 1
    elapsed = time.perf_counter() - start
    if args.matrix_free:
        print(f"eom-ccsd (matrix-free {args.formulation}) finished after {res.cc_iterations} CC "
              f"iterations and {elapsed:0.2f}s (amplitude space {res.dimension})")
    else:
        print(f"eom-ccsd finished after {res.cc_iterations} CC iterations and {elapsed:0.2f}s "
              f"({res.dimension} of {res.fci_dimension} determinants in the rank<=2 space)")
    print(f"hartree fock energy: {res.scf_total_energy:3.6f}")
    print(f"ccsd total energy: {res.ccsd_total_energy:3.6f}")
    _print_states(res.excitation_energies)
    return 0


def cmd_cis(args) -> int:
    from qchem_rs_tpu_torch.models.cis import cis, ucis

    system, cfg, device = _build(args)
    open_shell = _open_shell(system, cfg)
    start = time.perf_counter()
    try:
        if open_shell:
            if args.triplet or args.tdhf:
                print("--triplet/--tdhf apply to closed-shell references only "
                      "(open shells run spin-orbital UCIS)", file=sys.stderr)
                return 2
            res = ucis(system, cfg, nstates=args.nstates, device=device)
        else:
            if cfg.spin_multiplicity == 0:
                cfg = dataclasses.replace(cfg, spin_multiplicity=1)
            res = cis(system, cfg, nstates=args.nstates, triplet=args.triplet, tdhf=args.tdhf,
                      solver=args.solver, device=device)
    except (RuntimeError, ValueError) as e:
        print(str(e), file=sys.stderr)
        return 1
    elapsed = time.perf_counter() - start
    if res.method == "ucis":
        label = "ucis (spin-orbital)"
    else:
        label = f"{res.method} ({'triplet' if res.triplet else 'singlet'})"
    print(f"{label} finished after {res.iterations} SCF iterations and {elapsed:0.2f}s")
    print(f"hartree fock energy: {res.scf_total_energy:3.6f}")
    _print_states(res.excitation_energies, res.oscillator_strengths)
    return 0


def _geometry_config(system, cfg):
    """A closed shell's config with multiplicity 1 (open shells keep
    theirs and run UHF)."""
    if cfg.spin_multiplicity == 0 and not _open_shell(system, cfg):
        cfg = dataclasses.replace(cfg, spin_multiplicity=1)
    return cfg


def cmd_optimize(args) -> int:
    from qchem_rs_tpu_torch.models.optimize import optimize_geometry

    system, cfg, device = _build(args)
    cfg = _geometry_config(system, cfg)
    start = time.perf_counter()
    res = optimize_geometry(system, cfg, gtol=args.gtol, max_steps=args.max_steps, device=device)
    elapsed = time.perf_counter() - start
    status = "converged" if res.converged else "did NOT converge"
    print(f"geometry optimization {status} after {res.steps} energy/gradient "
          f"evaluations and {elapsed:0.2f}s")
    print(f"final energy: {res.energy:3.8f}")
    print(f"max |gradient|: {res.gradient_norm:.2e} Hartree/Bohr")
    print("final geometry (Bohr):")
    for atom, row in zip(system.atoms, res.positions):
        print(f"  {atom.ordinal:3d}  {row[0]: .6f} {row[1]: .6f} {row[2]: .6f}")
    return 0 if res.converged else 1


def cmd_frequencies(args) -> int:
    from qchem_rs_tpu_torch.models.hessian import harmonic_frequencies
    from qchem_rs_tpu_torch.models.optimize import optimize_geometry

    system, cfg, device = _build(args)
    cfg = _geometry_config(system, cfg)
    start = time.perf_counter()
    if args.opt_first:
        opt = optimize_geometry(system, cfg, device=device)
        if not opt.converged:
            print("geometry optimization did not converge", file=sys.stderr)
            return 1
        system = system.with_positions(opt.positions)
    res = harmonic_frequencies(system, cfg, device=device)
    elapsed = time.perf_counter() - start
    print(f"harmonic analysis finished in {elapsed:0.2f}s")
    print(f"near-zero (trans/rot) modes: {res.n_zero_modes}")
    vib = [f for f in res.frequencies_cm1 if abs(f) >= 50.0]
    print("harmonic frequencies (cm^-1):", " ".join(f"{f:8.1f}" for f in vib))
    if args.thermo:
        from qchem_rs_tpu_torch.models.thermo import thermochemistry

        th = thermochemistry(system, res.frequencies_cm1, temperature=args.temperature,
                             pressure=args.pressure, symmetry_number=args.symmetry_number,
                             spin_multiplicity=max(cfg.spin_multiplicity, 1))
        shape = "linear" if th.linear else (
            "atom" if not len(th.rotational_temperatures) else "nonlinear")
        print(f"thermochemistry (RRHO, {th.temperature:.2f} K, "
              f"{th.pressure:.0f} Pa, sigma={args.symmetry_number}, {shape}):")
        print(f"  zero-point energy: {th.zpe:.6f} Eh")
        print(f"  thermal energy (U - E_elec): {th.thermal_energy:.6f} Eh")
        print(f"  thermal enthalpy (H - E_elec): {th.thermal_enthalpy:.6f} Eh")
        print(f"  thermal gibbs (G - E_elec): {th.thermal_gibbs:.6f} Eh")
        p = th.entropy_parts
        print(f"  entropy: {th.entropy:.3f} J/(mol K)  [trans {p['trans']:.3f}"
              f", rot {p['rot']:.3f}, vib {p['vib']:.3f}, elec {p['elec']:.3f}]")
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


def cmd_sweep(args) -> int:
    """RHF over a batch of geometries of one molecule, or, with
    ``--chain``, one after another, each warm-started from the previous
    converged density. Under ``torchrun --nproc_per_node=N`` the
    conformers are shared over the N processes (``--chain`` runs the whole
    chain in each); only rank 0 prints."""
    import json

    import numpy as np
    import torch.distributed as dist

    from qchem_rs_tpu_torch.parallel.mesh import data_mesh, distributed_init
    from qchem_rs_tpu_torch.parallel.sweep import chained_sweep, conformer_sweep
    from qchem_rs_tpu_torch.utils.profiling import trace

    joined = distributed_init(_device(args.device))
    try:
        system, cfg, device = _build(args)
        mesh = data_mesh(device=device)
        try:
            with open(args.geometries) as f:
                geoms = np.asarray(json.load(f), dtype=np.float64)  # (nconf, natom, 3)
        except (OSError, ValueError) as e:
            raise CliError(f"cannot load geometries {args.geometries!r}: {e}") from e
        start = time.perf_counter()
        with trace(args.trace_dir):
            if args.chain:
                energies, converged = chained_sweep(system, geoms, cfg, device=mesh.device)
            else:
                energies, converged = conformer_sweep(system, geoms, cfg, mesh)
        elapsed = time.perf_counter() - start
        if mesh.rank == 0:
            print(f"swept {len(geoms)} conformers in {elapsed:0.2f}s")
            for i, (e, c) in enumerate(zip(energies, converged)):
                flag = "" if c else "  (NOT CONVERGED)"
                print(f"conformer {i}: {e:.8f}{flag}")
    finally:
        if joined:
            dist.destroy_process_group()
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
                   "diis_err, composite[:GUARD], espan:<W>[:<GUARD>] (energy span of the last W "
                   "passes); a trailing 2 needs two passes below epsilon")
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


def _frozen_flag(p: argparse.ArgumentParser) -> None:
    p.add_argument("--frozen-core", default="0", metavar="N|auto",
                   help="core spatial orbitals excluded from correlation: an integer or 'auto' "
                   "(1s for Li-Ne, 1s2s2p for Na-Ar)")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="qchem_rs_tpu_torch",
        description="Hartree-Fock and correlated methods on PyTorch + CUDA (port of qchem_rs_tpu)",
    )
    parser.add_argument("--verbose", "-v", action="store_true", help="per-iteration SCF logging")
    sub = parser.add_subparsers(dest="command", required=True)
    p = sub.add_parser("rhf", help="restricted Hartree-Fock single point")
    p.add_argument("--gradient", action="store_true",
                   help="also print the analytic nuclear gradient")
    p.add_argument("--polarizability", action="store_true",
                   help="also print the CPHF static dipole polarizability tensor (one (A+B) "
                   "linear solve)")
    _common_flags(p, uhf=False)
    p.set_defaults(fn=cmd_rhf)
    p = sub.add_parser("uhf", help="unrestricted Hartree-Fock single point")
    _common_flags(p, uhf=True)
    p.set_defaults(fn=cmd_uhf)
    p = sub.add_parser("mp2", help="MP2 correlation energy (restricted; spin-unrestricted UMP2 "
                       "for open shells)")
    _common_flags(p, uhf=True)
    _frozen_flag(p)
    p.set_defaults(fn=cmd_mp2)
    p = sub.add_parser("ccsd", help="CCSD / CCSD(T) correlation energy (closed shells on RHF, "
                       "open shells on UHF references)")
    _common_flags(p, uhf=True)
    _frozen_flag(p)
    p.add_argument("--triples", action="store_true", help="add the perturbative (T) correction")
    p.add_argument("--cc-epsilon", type=float, default=1e-8,
                   help="amplitude RMS / |dE| convergence threshold")
    # --dipole (of _common_flags) reports the unrelaxed CC dipole here
    p.add_argument("--relaxed", action="store_true",
                   help="with --dipole: orbital-relaxed dipole via the z-vector method")
    p.set_defaults(fn=cmd_ccsd)
    p = sub.add_parser("fci", help="determinant full CI for small systems (exact within the "
                       "basis; the correlation-tier anchor)")
    _common_flags(p, uhf=True)
    p.add_argument("--nroots", type=int, default=1, help="number of FCI roots to report")
    p.add_argument("--max-dim", type=int, default=4000,
                   help="determinant-space cap for the dense eigensolve tier")
    p.add_argument("--orbitals", choices=("auto", "rhf", "lowdin"), default="auto",
                   help="orbital basis: converged RHF or Loewdin-orthogonalized AOs (FCI is "
                   "invariant; lowdin needs no SCF and works for open shells)")
    p.set_defaults(fn=cmd_fci)
    p = sub.add_parser("eom", help="EOM-CCSD excitation energies (closed shells)")
    _common_flags(p, uhf=False)
    p.add_argument("--nstates", type=int, default=5, help="number of excited states")
    p.add_argument("--max-dim", type=int, default=4000,
                   help="determinant-space cap (same tier as fci)")
    p.add_argument("--ip", action="store_true",
                   help="ionization potentials (IP-EOM: 1h + 2h1p sector)")
    p.add_argument("--ea", action="store_true",
                   help="electron affinities (EA-EOM: 1p + 2p1h sector)")
    p.add_argument("--oscillator-strengths", action="store_true",
                   help="biorthogonal transition dipoles and length-gauge oscillator strengths "
                   "plus the CCSD ground-state dipole")
    p.add_argument("--matrix-free", action="store_true",
                   help="Davidson over jvp sigma vectors (no determinant space)")
    p.add_argument("--formulation", choices=("spinorbital", "spatial"), default="spinorbital",
                   help="matrix-free sigma path: spinorbital (all Ms=0 roots) or the spatial "
                   "fast path (singlet roots only)")
    p.set_defaults(fn=cmd_eom)
    p = sub.add_parser("cis", help="CIS / TDHF excitation energies (closed shells; open shells "
                       "run spin-orbital UCIS on the UHF reference; --fock-mode pair avoids the "
                       "n^4 AO tensor)")
    _common_flags(p, uhf=True)
    p.add_argument("--nstates", type=int, default=5, help="number of excited states")
    p.add_argument("--triplet", action="store_true", help="triplet excitations")
    p.add_argument("--tdhf", action="store_true",
                   help="full TDHF/RPA instead of the CIS (Tamm-Dancoff) problem")
    p.add_argument("--solver", choices=("auto", "dense", "davidson"), default="auto",
                   help="CIS eigensolver: dense diagonalization or implicit-sigma Davidson "
                   "(auto switches to davidson past no*nv = 4096)")
    p.set_defaults(fn=cmd_cis)
    p = sub.add_parser("optimize", help="geometry optimization on analytic gradients (RHF; UHF "
                       "for open shells)")
    _common_flags(p, uhf=True)
    p.add_argument("--gtol", type=float, default=3e-5,
                   help="max-abs gradient convergence threshold (Hartree/Bohr)")
    p.add_argument("--max-steps", type=int, default=50,
                   help="maximum optimizer energy/gradient evaluations")
    p.set_defaults(fn=cmd_optimize)
    p = sub.add_parser("frequencies", help="harmonic vibrational frequencies on a semi-numerical "
                       "Hessian of analytic gradients")
    _common_flags(p, uhf=True)
    p.add_argument("--opt-first", action="store_true",
                   help="optimize the geometry before the harmonic analysis")
    p.add_argument("--thermo", action="store_true",
                   help="ideal-gas RRHO thermochemistry (ZPE, U, H, G, S)")
    p.add_argument("--temperature", type=float, default=298.15, help="temperature (K)")
    p.add_argument("--pressure", type=float, default=101325.0, help="pressure (Pa)")
    p.add_argument("--symmetry-number", type=int, default=1,
                   help="rotational symmetry number sigma")
    p.set_defaults(fn=cmd_frequencies)
    p = sub.add_parser("sweep", help="batched conformer sweep (RHF); under torchrun "
                       "--nproc_per_node=N the conformers are shared over N devices and only "
                       "rank 0 prints")
    _common_flags(p, uhf=False)
    p.add_argument("--geometries", "-g", required=True,
                   help="JSON (nconf, natom, 3) positions in Bohr")
    p.add_argument("--chain", action="store_true",
                   help="sequential sweep, each conformer warm-started from the previous "
                   "density (for correlated scans; every process runs the whole chain)")
    p.set_defaults(fn=cmd_sweep)
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
