"""Determinant full CI for small systems (port of
``qchem_rs_tpu/models/fci.py``).

FCI is exact within the basis, so it anchors the correlation tier: CCSD on
a two-electron system must reproduce it, and every other method is bounded
by it. The Hamiltonian is assembled on the host over (alpha-string,
beta-string) determinant pairs with the spin-factorized Slater-Condon rules
(``_strings`` .. ``_build_hamiltonian``, numpy and Python ints, copied from
the JAX package), vectorized over the opposite spin sector, and solved by
one dense symmetric eigensolve; the dimension is capped at a few thousand
determinants. The n^5 MO transform that feeds it runs on ``device``: four
quarter-transforms, each one matrix product (``_transform_full``).

Full CI is invariant under any orthonormal orbital basis, so the solver
takes converged RHF orbitals (meaningful E_corr) or symmetric-Löwdin
orthogonalized AOs (no SCF; any (n_alpha, n_beta)).
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Optional

import numpy as np
import torch

from qchem_rs_tpu_torch.config import HartreeFockConfig
from qchem_rs_tpu_torch.models import scf
from qchem_rs_tpu_torch.models.rhf import check_device, core_hamiltonian, restricted_hartree_fock
from qchem_rs_tpu_torch.ops.eri_tiled import TiledEriEngine
from qchem_rs_tpu_torch.utils.system import MolecularSystem


@dataclasses.dataclass
class FciOutput:
    total_energies: np.ndarray  # (nroots,) ascending, nuclear repulsion included
    dimension: int
    n_alpha: int
    n_beta: int
    scf_total_energy: Optional[float]  # None when orbitals="lowdin"

    def total_energy(self) -> float:
        return float(self.total_energies[0])

    def correlation_energy(self) -> Optional[float]:
        if self.scf_total_energy is None:
            return None
        return self.total_energy() - self.scf_total_energy


def _transform_full(e4: torch.Tensor, C: torch.Tensor, C2: Optional[torch.Tensor] = None,
                    C3: Optional[torch.Tensor] = None,
                    C4: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(pq|rs) AO -> MO, four quarter-transforms, each one matrix product
    on a view of the previous buffer: index p takes C, q C2, r C3 and s C4
    (each C when not given)."""
    C2 = C if C2 is None else C2
    C3 = C if C3 is None else C3
    C4 = C3 if C4 is None else C4
    n = e4.shape[0]
    a, b, c, d = C.shape[1], C2.shape[1], C3.shape[1], C4.shape[1]
    x = C.T @ e4.reshape(n, n**3)  # [i, (q r s)]
    x = torch.matmul(C2.T, x.reshape(a, n, n * n))  # [i, j, (r s)]
    x = torch.matmul(C3.T, x.reshape(a * b, n, n))  # [(i j), k, s]
    return (x @ C4).reshape(a, b, c, d)


# --------------------------------------------------------------------------
# spin-string machinery (host-side, bitmask ints)
# --------------------------------------------------------------------------


def _strings(n: int, k: int) -> list[int]:
    """All k-electron occupation bitmasks over n orbitals, lexicographic."""
    out = []
    for occ in itertools.combinations(range(n), k):
        m = 0
        for p in occ:
            m |= 1 << p
        out.append(m)
    return out


def _occ(mask: int) -> list[int]:
    out, p = [], 0
    while mask:
        if mask & 1:
            out.append(p)
        mask >>= 1
        p += 1
    return out


def _single_phase(mask: int, i: int, a: int) -> int:
    """Parity of moving one electron i -> a within `mask` (i occupied,
    a empty): (-1)^(number of occupied orbitals strictly between them)."""
    lo, hi = (i, a) if i < a else (a, i)
    between = mask & (((1 << hi) - 1) ^ ((1 << (lo + 1)) - 1))
    return 1 - 2 * (bin(between).count("1") & 1)


def _sector_excitations(strings: list[int]):
    """Per-spin-sector excitation lists between the given strings.

    Returns (singles, doubles):
      singles: list of (I, J, i, a, phase)       J = I with i -> a
      doubles: list of (I, J, i, j, a, b, phase) holes i < j, parts a < b,
               phase = sequential application (i -> a, then j -> b)
    Both directions are enumerated independently (I -> J and J -> I appear
    as separate entries), so Hamiltonian symmetry is an emergent property
    the tests can check, not an imposed one.
    """
    index = {m: I for I, m in enumerate(strings)}
    n_max = max(strings).bit_length() if strings else 0
    singles, doubles = [], []
    for I, m in enumerate(strings):
        occ = _occ(m)
        virt = [p for p in range(n_max) if not (m >> p) & 1]
        for i in occ:
            for a in virt:
                m1 = m ^ (1 << i) | (1 << a)
                J = index.get(m1)
                if J is not None:
                    singles.append((I, J, i, a, _single_phase(m, i, a)))
        for i, j in itertools.combinations(occ, 2):
            for a, b in itertools.combinations(virt, 2):
                ph1 = _single_phase(m, i, a)
                m1 = m ^ (1 << i) | (1 << a)
                ph2 = _single_phase(m1, j, b)
                m2 = m1 ^ (1 << j) | (1 << b)
                J = index.get(m2)
                if J is not None:
                    doubles.append((I, J, i, j, a, b, ph1 * ph2))
    return singles, doubles


def _build_hamiltonian(h: np.ndarray, g: np.ndarray, na: int, nb: int) -> tuple[np.ndarray, int]:
    """Dense FCI Hamiltonian over (alpha-string x beta-string) determinants.

    `h` is the one-electron MO matrix, `g` the chemist-notation (pq|rs) MO
    tensor, both over one orthonormal spatial orbital set shared by the two
    spins. Determinant index = Ia * n_beta_strings + Ib (alpha-major).
    """
    n = h.shape[0]
    sa, sb = _strings(n, na), _strings(n, nb)
    na_str, nb_str = len(sa), len(sb)
    dim = na_str * nb_str
    H = np.zeros((dim, dim))

    occ_a = np.array([[(m >> p) & 1 for p in range(n)] for m in sa], dtype=float)
    occ_b = np.array([[(m >> p) & 1 for p in range(n)] for m in sb], dtype=float)
    Jmat = np.einsum("ppqq->pq", g)  # (pp|qq)
    Kmat = np.einsum("pqqp->pq", g)  # (pq|qp)
    gd = np.einsum("pqjj->pqj", g)  # (pq|jj): vectorized Coulomb column
    gx = np.einsum("pjjq->pqj", g)  # (pj|jq): vectorized exchange column

    # -- diagonal: (0,0) ----------------------------------------------------
    e1_a = occ_a @ np.diag(h)
    e1_b = occ_b @ np.diag(h)
    ee_same_a = 0.5 * np.einsum("Ip,pq,Iq->I", occ_a, Jmat - Kmat, occ_a)
    ee_same_b = 0.5 * np.einsum("Ip,pq,Iq->I", occ_b, Jmat - Kmat, occ_b)
    e_ab = occ_a @ Jmat @ occ_b.T  # (na_str, nb_str)
    diag = ((e1_a + ee_same_a)[:, None] + (e1_b + ee_same_b)[None, :] + e_ab).reshape(dim)
    H[np.arange(dim), np.arange(dim)] = diag

    singles_a, doubles_a = _sector_excitations(sa)
    singles_b, doubles_b = _sector_excitations(sb)
    ib_all = np.arange(nb_str)
    ia_all = np.arange(na_str)

    # -- alpha singles: (1,0) — vectorized over every beta string -----------
    for I, J, i, a, ph in singles_a:
        common = occ_a[I] * occ_a[J]  # spectators: occupied in both strings
        const = h[i, a] + common @ (gd[i, a] - gx[i, a])
        vals = ph * (const + occ_b @ gd[i, a])
        H[I * nb_str + ib_all, J * nb_str + ib_all] = vals

    # -- beta singles: (0,1) — vectorized over every alpha string -----------
    for I, J, i, a, ph in singles_b:
        common = occ_b[I] * occ_b[J]
        const = h[i, a] + common @ (gd[i, a] - gx[i, a])
        vals = ph * (const + occ_a @ gd[i, a])
        H[ia_all * nb_str + I, ia_all * nb_str + J] = vals

    # -- same-spin doubles: (2,0) / (0,2) ------------------------------------
    for I, J, i, j, a, b, ph in doubles_a:
        v = ph * (g[i, a, j, b] - g[i, b, j, a])
        H[I * nb_str + ib_all, J * nb_str + ib_all] = v
    for I, J, i, j, a, b, ph in doubles_b:
        v = ph * (g[i, a, j, b] - g[i, b, j, a])
        H[ia_all * nb_str + I, ia_all * nb_str + J] = v

    # -- opposite-spin doubles: (1,1) — vectorized over beta singles ---------
    if singles_b:
        sb_arr = np.array([(I, J, i, a, ph) for I, J, i, a, ph in singles_b])
        Ib, Jb = sb_arr[:, 0].astype(int), sb_arr[:, 1].astype(int)
        jb_i, jb_a = sb_arr[:, 2].astype(int), sb_arr[:, 3].astype(int)
        ph_b = sb_arr[:, 4]
        for I, J, i, a, ph in singles_a:
            vals = ph * ph_b * g[i, a, jb_i, jb_a]
            H[I * nb_str + Ib, J * nb_str + Jb] = vals

    return H, dim


def fci_from_integrals(
    h: np.ndarray,
    g: np.ndarray,
    n_alpha: int,
    n_beta: int,
    e_nuclear: float = 0.0,
    *,
    nroots: int = 1,
    max_dim: int = 4000,
) -> tuple[np.ndarray, int]:
    """Lowest `nroots` FCI total energies from MO-basis integrals. Raises
    when the determinant space exceeds `max_dim` (dense eigensolve tier)."""
    n = h.shape[0]
    dim = math.comb(n, n_alpha) * math.comb(n, n_beta)
    if dim > max_dim:
        raise ValueError(
            f"FCI dimension {dim} exceeds max_dim={max_dim}; this solver is "
            "the dense small-system tier (raise max_dim explicitly if you "
            "really want a bigger dense eigensolve)"
        )
    H, dim = _build_hamiltonian(np.asarray(h), np.asarray(g), n_alpha, n_beta)
    w = np.linalg.eigvalsh(H)
    return w[:nroots] + e_nuclear, dim


def mo_integrals(system: MolecularSystem, config: HartreeFockConfig, C: torch.Tensor):
    """(h, g) in the MO basis C, as numpy: h = C^T (T + V) C and the full
    (pq|rs) tensor from the in-core ERI build (kernel 1) on C's device."""
    _, H1, _, _ = core_hamiltonian(system, C.device)
    engine = TiledEriEngine(system, config.screening_threshold, device=C.device)
    e4 = engine.finish_eri(engine.build())
    g = _transform_full(e4, C)
    del e4
    return (C.T @ H1 @ C).cpu().numpy(), g.cpu().numpy()


def fci(
    system: MolecularSystem,
    config: Optional[HartreeFockConfig] = None,
    *,
    nroots: int = 1,
    max_dim: int = 4000,
    orbitals: str = "auto",
    device="cuda",
) -> FciOutput:
    """Full CI ground (and optionally excited) state total energies.

    orbitals:
      "rhf"    — converged closed-shell RHF orbitals (records E_SCF so
                 correlation_energy() is meaningful); even-electron only.
      "lowdin" — symmetric-Löwdin orthogonalized AOs; no SCF needed, works
                 for any (n_alpha, n_beta). Same eigenvalues (invariance).
      "auto"   — "rhf" for closed shells, else "lowdin".
    """
    config = config or HartreeFockConfig(epsilon=1e-10, max_iterations=200)
    device = check_device(device)
    na, nb = scf.electron_counts(system.n_electrons(config.charge), config.spin_multiplicity)
    if orbitals == "auto":
        orbitals = "rhf" if na == nb else "lowdin"

    scf_total = None
    if orbitals == "rhf":
        if na != nb:
            raise ValueError("orbitals='rhf' requires a closed shell")
        out = restricted_hartree_fock(system, config, device=device)
        if not out.converged:
            raise RuntimeError("SCF not converged; pass orbitals='lowdin'")
        C = torch.as_tensor(out.coefficients, dtype=torch.float64, device=device)
        scf_total = out.total_energy()
    elif orbitals == "lowdin":
        _, _, C, _ = core_hamiltonian(system, device)
    else:
        raise ValueError(f"unknown orbitals={orbitals!r}")

    h_mo, g_mo = mo_integrals(system, config, C)
    energies, dim = fci_from_integrals(h_mo, g_mo, na, nb, float(system.nuclear_repulsion()),
                                       nroots=nroots, max_dim=max_dim)
    return FciOutput(total_energies=energies, dimension=dim, n_alpha=na, n_beta=nb,
                     scf_total_energy=scf_total)
