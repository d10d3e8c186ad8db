"""MP2 correlation energy on converged RHF or UHF orbitals (port of
``qchem_rs_tpu/models/mp2.py``).

    E_MP2 = sum_{ijab} (ia|jb) [ 2 (ia|jb) - (ib|ja) ]
            / (eps_i + eps_j - eps_a - eps_b)

for a closed shell, and per spin block for UHF (``ump2``). The (ia|jb)
integrals come from either of the port's ERI storage forms:

- in core (``mp2``, ``ump2``): the (n, n, n, n) tensor of
  ``TiledEriEngine.finish_eri``, transformed one index at a time by four
  matrix products (``_transform_ovov``); the V2 build behind it runs
  kernel 1;
- in pair space (``mp2_pair_space``, ``ump2_pair_space``): no n^4 tensor,
  (ia|jb) = U^T V2f U with U the (M, no*nv) MO pair-distribution matrix
  over the rows of the mirrored pair matrix V2f, two matrix products. A
  pair-mode builder whose V2f is already prepared (its SCF ran in pair
  mode) is reused; otherwise V2f is built (kernel 1) and mirrored, without
  W. A sharded builder over a mesh (``mp2_pair_space`` only) contracts
  each rank's column slab and sums the result over the ranks; the other
  pair-space callers of V2f (``_pair_v2f``) refuse it.

The quarter-transforms and U^T V2f U are plain ``torch`` products: the JAX
package does them outside any Pallas kernel too. Every entry point runs
the SCF on ``device`` when no converged ``output`` is given, defaults to
the card and raises without CUDA.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from qchem_rs_tpu_torch.config import HartreeFockConfig
from qchem_rs_tpu_torch.models import scf
from qchem_rs_tpu_torch.models.rhf import _sync, check_device, restricted_hartree_fock
from qchem_rs_tpu_torch.models.uhf import unrestricted_hartree_fock
from qchem_rs_tpu_torch.ops.eri_tiled import TiledEriEngine, mirror_inplace
from qchem_rs_tpu_torch.ops.fock_pair import PairSpaceFockBuilder, pair_row_ao
from qchem_rs_tpu_torch.utils.system import MolecularSystem


@dataclasses.dataclass
class Mp2Output:
    scf_total_energy: float
    correlation_energy: float
    iterations: int
    # extra beyond the JAX package's output: eri_s (the V2 build and its
    # finish), transform_s (the MO transform and the energy sum), total_s
    # (both; the SCF not included)
    timings: dict = dataclasses.field(default_factory=dict)

    def total_energy(self) -> float:
        return self.scf_total_energy + self.correlation_energy


#: chemical-core orbital counts per element (H..Ar; Z -> frozen spatial
#: orbitals): 1s for Li-Ne, 1s2s2p for Na-Ar. Used by frozen="auto".
_CORE_ORBITALS = {z: 0 for z in (1, 2)}
_CORE_ORBITALS.update({z: 1 for z in range(3, 11)})
_CORE_ORBITALS.update({z: 5 for z in range(11, 19)})


def _n_frozen(system, frozen) -> int:
    """The frozen-core orbital count: "auto" takes the chemical-core table,
    an int passes through (0 freezes none)."""
    if frozen == "auto":
        try:
            return sum(_CORE_ORBITALS[a.ordinal] for a in system.atoms)
        except KeyError as e:
            raise ValueError(
                f"no frozen-core count for element Z={e.args[0]}; pass an explicit integer"
            ) from None
    n = int(frozen)
    if n < 0:
        raise ValueError("frozen must be >= 0 or 'auto'")
    return n


def _mp2_from_mo(ovov: torch.Tensor, eps_o: torch.Tensor, eps_v: torch.Tensor) -> torch.Tensor:
    """E_MP2 from (ia|jb) integrals, shape (no, nv, no, nv)."""
    denom = (eps_o[:, None, None, None] + eps_o[None, None, :, None]
             - eps_v[None, :, None, None] - eps_v[None, None, None, :])
    return torch.sum(ovov / denom * (2.0 * ovov - ovov.permute(0, 3, 2, 1)))


def _transform_ovov(e4: torch.Tensor, Co: torch.Tensor, Cv: torch.Tensor,
                    Co2: Optional[torch.Tensor] = None,
                    Cv2: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(pq|rs) -> (ia|jb), shape (no, nv, no2, nv2): four quarter-transforms,
    each one matrix product on a view of the previous buffer (no copy of
    e4). The ket side takes (Co2, Cv2) when given (UMP2's opposite-spin
    block), else (Co, Cv)."""
    Co2 = Co if Co2 is None else Co2
    Cv2 = Cv if Cv2 is None else Cv2
    n, no, nv, no2, nv2 = e4.shape[0], Co.shape[1], Cv.shape[1], Co2.shape[1], Cv2.shape[1]
    x = Co.T @ e4.reshape(n, n**3)  # [i, (q r s)]
    x = Cv.T @ x.view(no, n, n * n)  # [i, a, (r s)]
    x = Co2.T @ x.view(no * nv, n, n)  # [(i a), j, s]
    x = x @ Cv2  # [(i a), j, b]
    return x.reshape(no, nv, no2, nv2)


def _pair_transform_matrix(builder, Co: torch.Tensor, Cv: torch.Tensor) -> torch.Tensor:
    """U[P, (ia)] such that (ia|jb) = U^T V2f U: the occupied-virtual MO
    pair distribution over the unordered AO-pair rows of V2f. Row P
    holding AO pair (p, q) carries C_pi C_qa + (p != q) C_qi C_pa; padding
    and redundant rows carry zero (their values repeat the canonical
    row's)."""
    row_i, row_j, dup = pair_row_ao(builder.engine.layout)
    pad = row_i < 0
    dev, f64 = Co.device, Co.dtype
    p = torch.as_tensor(np.where(pad, 0, row_i), device=dev)
    q = torch.as_tensor(np.where(pad, 0, row_j), device=dev)
    dead = torch.as_tensor(pad | dup, device=dev)
    off = torch.where(dead | (p == q), 0.0, 1.0).to(f64)[:, None]
    live = torch.where(dead, 0.0, 1.0).to(f64)[:, None]
    no, nv = Co.shape[1], Cv.shape[1]
    U = live * (Co[p][:, :, None] * Cv[q][:, None, :]).reshape(-1, no * nv)
    return U + off * (Co[q][:, :, None] * Cv[p][:, None, :]).reshape(-1, no * nv)


def _pair_v2f(system, config, device, builder) -> tuple[torch.Tensor, PairSpaceFockBuilder]:
    """The mirrored V2f of ``builder`` (a pair-mode builder's prepared one
    when there is one), or of a new builder's build. A sharded builder
    (one with a ``mesh``) raises: it holds a column slab, not V2f."""
    if hasattr(builder, "mesh"):
        raise ValueError(f"{type(builder).__name__} holds a column slab of V2f over a mesh, "
                         "not the whole V2f; only mp2_pair_space contracts against it")
    builder = builder or PairSpaceFockBuilder(system, config.screening_threshold, device=device,
                                              lean=True)
    if builder._prepared is not None:
        return builder._prepared[0], builder
    return mirror_inplace(builder.engine.build()), builder


def _check_output(out) -> None:
    if not out.converged:
        raise RuntimeError("SCF not converged; MP2 would be meaningless")


def _rhf_setup(system, config, frozen, output, device):
    """(config, SCF output, nocc, frozen count, C, eps) of a closed-shell
    MP2 run on ``device``."""
    config = config or HartreeFockConfig(epsilon=1e-10, max_iterations=200)
    device = check_device(device)
    out = output or restricted_hartree_fock(system, config, device=device)
    _check_output(out)
    nocc = system.n_electrons(config.charge) // 2
    nfz = _n_frozen(system, frozen)
    if nfz >= nocc:
        raise ValueError(f"frozen={nfz} leaves no correlated occupied orbitals")
    C = torch.as_tensor(out.coefficients, dtype=torch.float64, device=device)
    eps = torch.as_tensor(out.orbital_energies, dtype=torch.float64, device=device)
    return config, out, nocc, nfz, C, eps


def _uhf_setup(system, config, frozen, output, device):
    """(config, SCF output, (nalpha, nbeta), frozen count, C (2, n, n), eps
    (2, n)) of a UMP2 run on ``device``."""
    config = config or HartreeFockConfig(epsilon=1e-10, max_iterations=300)
    device = check_device(device)
    out = output or unrestricted_hartree_fock(system, config, device=device)
    _check_output(out)
    nocc = scf.electron_counts(system.n_electrons(config.charge), config.spin_multiplicity)
    nfz = _n_frozen(system, frozen)
    if nfz >= min(nocc):
        raise ValueError(f"frozen={nfz} leaves no correlated occupied orbitals")
    C = torch.as_tensor(out.coefficients, dtype=torch.float64, device=device)
    eps = torch.as_tensor(np.stack([out.orbital_energies_alpha, out.orbital_energies_beta]),
                          dtype=torch.float64, device=device)
    return config, out, nocc, nfz, C, eps


def _result(out, ecorr: torch.Tensor, t0: float, t1: float, device) -> Mp2Output:
    value = float(ecorr)
    _sync(device)
    t2 = time.perf_counter()
    return Mp2Output(scf_total_energy=out.total_energy(), correlation_energy=value,
                     iterations=out.iterations,
                     timings={"eri_s": t1 - t0, "transform_s": t2 - t1, "total_s": t2 - t0})


def mp2(
    system: MolecularSystem,
    config: Optional[HartreeFockConfig] = None,
    *,
    frozen: int | str = 0,
    output=None,
    device="cuda",
) -> Mp2Output:
    """Run (or reuse) a converged RHF and return the MP2 correlation
    energy, in core.

    Tight SCF convergence is recommended (epsilon <= 1e-8): the correlation
    energy inherits first-order sensitivity to the orbital residual.
    ``frozen``: core spatial orbitals left out of the correlation (0, an
    int, or "auto" for the chemical core: 1s for Li-Ne, 1s2s2p for
    Na-Ar)."""
    config, out, nocc, nfz, C, eps = _rhf_setup(system, config, frozen, output, device)
    t0 = time.perf_counter()
    engine = TiledEriEngine(system, config.screening_threshold, device=C.device)
    e4 = engine.finish_eri(engine.build())
    _sync(C.device)
    t1 = time.perf_counter()
    ovov = _transform_ovov(e4, C[:, nfz:nocc], C[:, nocc:])
    del e4
    return _result(out, _mp2_from_mo(ovov, eps[nfz:nocc], eps[nocc:]), t0, t1, C.device)


def mp2_pair_space(
    system: MolecularSystem,
    config: Optional[HartreeFockConfig] = None,
    *,
    frozen: int | str = 0,
    output=None,
    builder: Optional[PairSpaceFockBuilder] = None,
    device="cuda",
) -> Mp2Output:
    """MP2 through the pair-space ERI matrix, with no n^4 tensor:
    (ia|jb) = U^T V2f U. Peak memory is V2f, U and the (no*nv)^2 result.
    ``builder``: a ``PairSpaceFockBuilder`` whose prepared V2f is reused
    (else V2f is built and mirrored once), or a sharded one over a mesh
    (``PairSpaceShardedFockBuilder``, ``ColumnShardedPairFockBuilder``),
    whose ``mo_pair_contract`` contracts each rank's column slab and
    sums the (no*nv)^2 result over the ranks. A spherical system's C is
    lifted to the Cartesian AOs of V2f."""
    config, out, nocc, nfz, C, eps = _rhf_setup(system, config, frozen, output, device)
    if system.spherical:
        C = torch.as_tensor(system.sph_T, dtype=C.dtype, device=C.device) @ C
    no, nv = nocc - nfz, C.shape[1] - nocc
    t0 = time.perf_counter()
    if hasattr(builder, "mo_pair_contract"):
        builder.v2f_slab()
        _sync(C.device)
        t1 = time.perf_counter()
        U = _pair_transform_matrix(builder, C[:, nfz:nocc], C[:, nocc:])
        ovov = builder.mo_pair_contract(U).reshape(no, nv, no, nv)
        return _result(out, _mp2_from_mo(ovov, eps[nfz:nocc], eps[nocc:]), t0, t1, C.device)
    V2f, builder = _pair_v2f(system, config, C.device, builder)
    _sync(C.device)
    t1 = time.perf_counter()
    U = _pair_transform_matrix(builder, C[:, nfz:nocc], C[:, nocc:])
    ovov = (U.T @ (V2f @ U)).reshape(no, nv, no, nv)
    return _result(out, _mp2_from_mo(ovov, eps[nfz:nocc], eps[nocc:]), t0, t1, C.device)


def _ump2_pair(ss_a, ss_b, os_ab, eo_a, ev_a, eo_b, ev_b) -> torch.Tensor:
    """UMP2 energy from the three spin-block (ia|jb) tensors."""

    def denom(eo1, ev1, eo2, ev2):
        return (eo1[:, None, None, None] + eo2[None, None, :, None]
                - ev1[None, :, None, None] - ev2[None, None, None, :])

    def same_spin(ovov, eo, ev):
        anti = ovov - ovov.permute(0, 3, 2, 1)
        return 0.25 * torch.sum(anti * anti / denom(eo, ev, eo, ev))

    e_os = torch.sum(os_ab * os_ab / denom(eo_a, ev_a, eo_b, ev_b))
    return same_spin(ss_a, eo_a, ev_a) + same_spin(ss_b, eo_b, ev_b) + e_os


def _ump2_energy(blocks, eps, nocc, nfz) -> torch.Tensor:
    ss_a, ss_b, os_ab = blocks
    return _ump2_pair(ss_a, ss_b, os_ab, eps[0][nfz : nocc[0]], eps[0][nocc[0] :],
                      eps[1][nfz : nocc[1]], eps[1][nocc[1] :])


def ump2(
    system: MolecularSystem,
    config: Optional[HartreeFockConfig] = None,
    *,
    frozen: int | str = 0,
    output=None,
    device="cuda",
) -> Mp2Output:
    """Spin-unrestricted MP2 on converged UHF orbitals, in core:

        E = 1/4 sum_ss |(ia|jb) - (ib|ja)|^2 / D  +  sum_os (ia|jb)^2 / D

    per same-spin block plus the opposite-spin block. Equal to the
    closed-shell result when alpha == beta."""
    config, out, nocc, nfz, C, eps = _uhf_setup(system, config, frozen, output, device)
    t0 = time.perf_counter()
    engine = TiledEriEngine(system, config.screening_threshold, device=C.device)
    e4 = engine.finish_eri(engine.build())
    _sync(C.device)
    t1 = time.perf_counter()
    Co = [C[s][:, nfz : nocc[s]] for s in range(2)]
    Cv = [C[s][:, nocc[s] :] for s in range(2)]
    blocks = (_transform_ovov(e4, Co[0], Cv[0]), _transform_ovov(e4, Co[1], Cv[1]),
              _transform_ovov(e4, Co[0], Cv[0], Co[1], Cv[1]))  # opposite spin: bra alpha, ket beta
    del e4
    return _result(out, _ump2_energy(blocks, eps, nocc, nfz), t0, t1, C.device)


def ump2_pair_space(
    system: MolecularSystem,
    config: Optional[HartreeFockConfig] = None,
    *,
    frozen: int | str = 0,
    output=None,
    builder: Optional[PairSpaceFockBuilder] = None,
    device="cuda",
) -> Mp2Output:
    """UMP2 through the pair-space ERI matrix, with no n^4 tensor: the
    same-spin blocks U_s^T V2f U_s and the opposite-spin block
    U_a^T V2f U_b."""
    config, out, nocc, nfz, C, eps = _uhf_setup(system, config, frozen, output, device)
    if system.spherical:
        C = torch.einsum("pq,sqm->spm", torch.as_tensor(system.sph_T, dtype=C.dtype,
                                                         device=C.device), C)
    t0 = time.perf_counter()
    V2f, builder = _pair_v2f(system, config, C.device, builder)
    _sync(C.device)
    t1 = time.perf_counter()
    U = [_pair_transform_matrix(builder, C[s][:, nfz : nocc[s]], C[s][:, nocc[s] :])
         for s in range(2)]
    shapes = [(nocc[s] - nfz, C.shape[2] - nocc[s]) for s in range(2)]
    VU = [V2f @ U[s] for s in range(2)]
    blocks = ((U[0].T @ VU[0]).reshape(*shapes[0], *shapes[0]),
              (U[1].T @ VU[1]).reshape(*shapes[1], *shapes[1]),
              (U[0].T @ VU[1]).reshape(*shapes[0], *shapes[1]))
    return _result(out, _ump2_energy(blocks, eps, nocc, nfz), t0, t1, C.device)
