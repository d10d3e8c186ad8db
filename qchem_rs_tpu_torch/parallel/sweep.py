"""Conformer sweeps: RHF over a batch of geometries of one molecule (port
of ``qchem_rs_tpu/parallel/sweep.py``).

The JAX package traces one RHF program, vmaps it over the geometries and
shards the batch over its device mesh. The port runs one process per
device: each rank takes its share of the conformers and runs them one
after another on its device, and the energies and ``converged`` flags are
gathered back in the input order. No vmap of the SCF is needed.

    energies, converged = conformer_sweep(system, geometries, config)
    energies, converged = chained_sweep(system, geometries, config)

Each conformer runs in core: kernel 1 builds its operator, kernel 2 takes
each pass's matvec (``models/rhf.py``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from qchem_rs_tpu_torch.config import HartreeFockConfig
from qchem_rs_tpu_torch.models.rhf import (_rhf_scf, check_device, core_hamiltonian,
                                           restricted_hartree_fock, two_electron_operator)
from qchem_rs_tpu_torch.parallel.mesh import data_mesh
from qchem_rs_tpu_torch.utils import interop
from qchem_rs_tpu_torch.utils.system import MolecularSystem


def rhf_energy_fn(system: MolecularSystem, config: HartreeFockConfig, device="cuda"):
    """positions (natom, 3) [, density_guess] -> (total energy, converged,
    iterations, density) by RHF on ``device`` (port of
    ``qchem_rs_tpu/parallel/sweep.py:143-183``): in-core operator terms
    whatever ``config.fock_mode`` says, as the JAX function builds them;
    a start from Hückel's guess unless a density (numpy or tensor
    (n, n)) is passed; DIIS(4, 6). Like the JAX function it takes no field
    and no level shift and prints nothing. The result equals in bits a
    ``restricted_hartree_fock`` run in core from Hückel at that geometry."""
    device = check_device(device)
    nocc = system.n_electrons(config.charge) // 2
    n = system.n_basis()
    incore = dataclasses.replace(config, fock_mode="incore")
    scf_config = dataclasses.replace(config, level_shift=0.0, verbose=False)

    def fn(positions, density_guess=None):
        at = system.with_positions(np.asarray(positions, dtype=np.float64))
        S, H, X, _ = core_hamiltonian(at, device)
        _, g_fn = two_electron_operator(at, incore, device)
        D0 = density_guess
        if D0 is not None and not isinstance(D0, torch.Tensor):
            D0 = interop.density_guess(D0, n, 1, device)
        st = _rhf_scf(H, X, S, nocc, scf_config, g_fn, D0)
        return st.energy + at.nuclear_repulsion(), st.converged, st.passes - 1, st.density

    return fn


def conformer_sweep(
    system: MolecularSystem,
    geometries: np.ndarray,
    config: HartreeFockConfig | None = None,
    mesh=None,
    *,
    device="cuda",
) -> tuple[np.ndarray, np.ndarray]:
    """RHF total energies for a batch of geometries (nconf, natom, 3) and
    their ``converged`` flags, in the input order (port of
    ``qchem_rs_tpu/parallel/sweep.py:186-216``). ``mesh`` (default
    ``data_mesh``: the process group's, or one device) shares the
    conformers over its ranks, each running its contiguous share in turn
    with ``rhf_energy_fn``; one ``all_reduce`` of each result (every other
    rank adds exact zeros) gathers them."""
    config = config or HartreeFockConfig()
    mesh = mesh or data_mesh(device=device)
    geometries = np.asarray(geometries, dtype=np.float64)
    fn = rhf_energy_fn(system, config, mesh.device)
    energies = torch.zeros(len(geometries), dtype=torch.float64, device=mesh.device)
    converged = torch.zeros_like(energies)
    share = mesh.share(len(geometries))
    for k in range(share.start, share.stop):
        total, conv, _, _ = fn(geometries[k])
        energies[k], converged[k] = total, float(conv)
    mesh.all_reduce(energies)
    mesh.all_reduce(converged)
    return energies.cpu().numpy(), converged.cpu().numpy() > 0.5


def chained_sweep(
    system: MolecularSystem,
    geometries: np.ndarray,
    config: HartreeFockConfig | None = None,
    *,
    device="cuda",
) -> tuple[np.ndarray, np.ndarray]:
    """Sequential sweep with warm starts (port of
    ``qchem_rs_tpu/parallel/sweep.py:219-266``): each geometry's SCF starts
    from the last converged density instead of a fresh guess, which
    shortens correlated scans (reaction paths, bond stretches). In core
    the chain runs through ``rhf_energy_fn`` (Hückel for the first
    geometry); the pair and direct modes through
    ``restricted_hartree_fock(..., density_guess=...)``, each geometry
    with its own engine. Returns (energies, converged)."""
    config = config or HartreeFockConfig()
    device = check_device(device)
    energies, converged = [], []
    guess = None
    fn = rhf_energy_fn(system, config, device) if config.fock_mode == "incore" else None
    for pos in np.asarray(geometries, dtype=np.float64):
        if fn is not None:
            total, conv, _, density = fn(pos, guess)
        else:
            out = restricted_hartree_fock(system.with_positions(pos), config,
                                          density_guess=guess, device=device)
            total, conv, density = out.total_energy(), out.converged, out.density
        energies.append(total)
        converged.append(conv)
        if conv:
            guess = density
    return np.asarray(energies), np.asarray(converged)
