"""Static and dynamic dipole polarizabilities by CPHF/TDHF linear response
(port of ``qchem_rs_tpu/models/response.py``).

The static polarizability is the zero-frequency limit of the TDHF
response,

    alpha_xy = 4 d_x^T (A + B)^{-1} d_y,

with A and B the singlet orbital-Hessian blocks (``models/cis.py``) and d
the occupied-virtual MO dipole blocks; alpha(omega) is the Casida form
4 (S d)^T (S (A + B) S - omega^2)^{-1} (S d) with S = (A - B)^{1/2}. The MO
integral blocks come from the in-core tensor (kernel 1) or, in pair mode,
from the pair-space V2f (``cis._cis_blocks_pair``: no n^4 AO tensor). The
solves are plain torch on ``device``, as the JAX package's are XLA.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from qchem_rs_tpu_torch.config import HartreeFockConfig
from qchem_rs_tpu_torch.models.cc import _incore_e4
from qchem_rs_tpu_torch.models.cis import (
    _assemble_AB,
    _cis_blocks_pair,
    _mo_transition_dipoles,
    _transform_oovv,
)
from qchem_rs_tpu_torch.models.mp2 import _pair_v2f, _transform_ovov
from qchem_rs_tpu_torch.models.rhf import check_device, restricted_hartree_fock
from qchem_rs_tpu_torch.utils.system import MolecularSystem


def _response_blocks(system, config, output, device):
    """Singlet (A, B) and the MO dipole rows d_ov (3, no*nv) of a converged
    RHF reference on ``device``."""
    device = check_device(device)
    out = output or restricted_hartree_fock(system, config, device=device)
    if not out.converged:
        raise RuntimeError("SCF not converged; response needs a converged reference")
    nocc = system.n_electrons(config.charge) // 2
    C = torch.as_tensor(out.coefficients, dtype=torch.float64, device=device)
    eps = torch.as_tensor(out.orbital_energies, dtype=torch.float64, device=device)
    if config.fock_mode == "pair":
        Cx = C
        if system.spherical:
            # V2f is Cartesian: lift the MO coefficients
            Cx = torch.as_tensor(system.sph_T, dtype=C.dtype, device=device) @ C
        V2f, builder = _pair_v2f(system, config, device, None)
        ovov, oovv = _cis_blocks_pair(builder, V2f, Cx[:, :nocc], Cx[:, nocc:])
        del V2f, builder
    else:
        e4 = _incore_e4(system, config, device)
        ovov = _transform_ovov(e4, C[:, :nocc], C[:, nocc:])
        oovv = _transform_oovv(e4, C[:, :nocc], C[:, nocc:])
        del e4
    A, B = _assemble_AB(ovov, oovv, eps[:nocc], eps[nocc:], True)
    d_ov = _mo_transition_dipoles(system, C, nocc).reshape(3, -1)
    return A, B, d_ov


def static_polarizability(
    system: MolecularSystem,
    config: Optional[HartreeFockConfig] = None,
    *,
    output=None,
    device="cuda",
) -> np.ndarray:
    """Static dipole polarizability tensor (3, 3), atomic units, of a
    converged RHF (``output``, or a new run) on ``device``.

    ``config.fock_mode == "pair"`` takes the MO blocks from the pair-space
    V2f. Raises on an unstable RHF reference (A + B is then not positive
    definite and the static response diverges)."""
    config = config or HartreeFockConfig(epsilon=1e-10, max_iterations=200)
    A, B, d_ov = _response_blocks(system, config, output, device)
    alpha = (4.0 * (d_ov @ torch.linalg.solve(A + B, d_ov.T))).cpu().numpy()
    if not np.all(np.linalg.eigvalsh(alpha) > 0):
        raise RuntimeError(
            "polarizability not positive definite: the RHF reference is "
            "unstable; the static response is undefined"
        )
    return alpha


def dynamic_polarizability(
    system: MolecularSystem,
    config: Optional[HartreeFockConfig] = None,
    *,
    omega: float = 0.0,
    output=None,
    device="cuda",
) -> np.ndarray:
    """Frequency-dependent dipole polarizability alpha(omega), (3, 3) a.u.:
    the TDHF response at real frequency omega (Hartree) in the Casida form;
    omega = 0 gives ``static_polarizability``. Valid between poles (the
    TDHF excitation energies); raises on an unstable reference."""
    config = config or HartreeFockConfig(epsilon=1e-10, max_iterations=200)
    A, B, d_ov = _response_blocks(system, config, output, device)
    wm, Um = torch.linalg.eigh(A - B)
    if float(wm.min()) <= 0.0:
        raise RuntimeError(
            "A - B is not positive definite: the RHF reference is unstable; "
            "the TDHF response is undefined"
        )
    S = (Um * torch.sqrt(wm)) @ Um.T
    M = S @ (A + B) @ S - (omega**2) * torch.eye(A.shape[0], dtype=A.dtype, device=A.device)
    Sd = S @ d_ov.T  # (n, 3)
    return (4.0 * (Sd.T @ torch.linalg.solve(M, Sd))).cpu().numpy()
