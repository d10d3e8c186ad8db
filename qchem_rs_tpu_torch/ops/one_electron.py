"""One-electron integrals: overlap S, kinetic T, nuclear attraction V and the
dipole moment matrices <i| r |j> (port of
``qchem_rs_tpu/ops/one_electron.py:130-212``), in the system's working
basis: a spherical system's Cartesian matrices are projected as
``sph_T^T X sph_T`` (``qchem_rs_tpu/ops/one_electron.py:120-122``).

Shell pairs are batched per (la, lb) class with padded primitive axes; each
class is one batched tensor computation. Padded primitives carry
coefficient 0 and contribute nothing. Plain PyTorch: these matrices are
(nao, nao) and cost milliseconds next to the ERI build.

Each entry point takes an optional ``positions`` tensor (natom, 3) in place
of ``system.positions``; autograd then follows the matrices back to it (the
nuclear gradients of ``models/gradients.py``). Without one the result is
the same as before, bit for bit.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from qchem_rs_tpu_torch.ops.angular import cart_components, ncart
from qchem_rs_tpu_torch.ops.mcmurchie import e_cubes, hermite_expansion_dense, r_table_leading
from qchem_rs_tpu_torch.utils.system import MolecularSystem, ShellClass


def _t(x, device):
    return torch.as_tensor(x, dtype=torch.float64, device=device)


def _pair_batch(ca: ShellClass, cb: ShellClass, positions: torch.Tensor):
    """Full cross product of shells from two classes as flat batched tensors."""
    dev = positions.device
    nA, nB = ca.nshells, cb.nshells
    ia, ib = np.meshgrid(np.arange(nA), np.arange(nB), indexing="ij")
    ia, ib = ia.ravel(), ib.ravel()
    a = _t(ca.alphas[ia], dev)[:, :, None]  # (n, Ka, 1)
    b = _t(cb.alphas[ib], dev)[:, None, :]  # (n, 1, Kb)
    cc = _t(ca.coefs[ia], dev)[:, :, None] * _t(cb.coefs[ib], dev)[:, None, :]
    A = positions[torch.as_tensor(ca.atom_indices[ia], device=dev)]  # (n, 3)
    B = positions[torch.as_tensor(cb.atom_indices[ib], device=dev)]
    AB = (A - B)[:, None, None, :]  # (n, 1, 1, 3)
    return ia, ib, a, b, cc, A, B, AB


def _overlap_class(la, lb, a, b, cc, AB):
    p = a + b
    ex, ey, ez = e_cubes(la, lb, a, b, AB)
    pref = (math.pi / p) ** 1.5 * cc  # (n, Ka, Kb)
    blocks = []
    for (i1, j1, k1) in cart_components(la):
        row = []
        for (i2, j2, k2) in cart_components(lb):
            s = ex[..., i1, i2, 0] * ey[..., j1, j2, 0] * ez[..., k1, k2, 0]
            row.append(torch.sum(pref * s, dim=(-1, -2)))
        blocks.append(torch.stack(row, dim=-1))
    return torch.stack(blocks, dim=-2)  # (n, ncA, ncB)


def _kinetic_class(la, lb, a, b, cc, AB):
    p = a + b
    # per-dimension overlaps up to j+2 on the ket side
    ex, ey, ez = e_cubes(la, lb + 2, a, b, AB)
    pref = (math.pi / p) ** 1.5 * cc

    def tdim(e, i, j):
        # d^2/dx^2 x^j e^{-b x^2} = j(j-1) x^{j-2} - 2b(2j+1) x^j + 4b^2 x^{j+2}
        term = -2.0 * b * b * e[..., i, j + 2, 0] + b * (2 * j + 1) * e[..., i, j, 0]
        if j >= 2:
            term = term - 0.5 * j * (j - 1) * e[..., i, j - 2, 0]
        return term

    blocks = []
    for (i1, j1, k1) in cart_components(la):
        row = []
        for (i2, j2, k2) in cart_components(lb):
            sx = ex[..., i1, i2, 0]
            sy = ey[..., j1, j2, 0]
            sz = ez[..., k1, k2, 0]
            t = (
                tdim(ex, i1, i2) * sy * sz
                + sx * tdim(ey, j1, j2) * sz
                + sx * sy * tdim(ez, k1, k2)
            )
            row.append(torch.sum(pref * t, dim=(-1, -2)))
        blocks.append(torch.stack(row, dim=-1))
    return torch.stack(blocks, dim=-2)


def _nuclear_class(la, lb, a, b, cc, A, B, AB, charges, positions):
    p = a + b  # (n, Ka, Kb)
    P = (a[..., None] * A[:, None, None, :] + b[..., None] * B[:, None, None, :]) / p[..., None]
    E = hermite_expansion_dense(la, lb, a, b, AB)  # (n, Ka, Kb, A, S)
    PC = P[None, ...] - positions[:, None, None, None, :]  # (nat, n, Ka, Kb, 3)
    R = r_table_leading(la + lb, p[None, ...], PC)  # (S, nat, n, Ka, Kb)
    RZ = torch.einsum("c,scnab->snab", charges, R)
    pref = (2.0 * math.pi / p) * cc
    V = -torch.einsum("nab,nabAs,snab->nA", pref, E, RZ)
    return V.reshape(V.shape[0], ncart(la), ncart(lb))


def _positions(system: MolecularSystem, device, positions) -> torch.Tensor:
    """``positions`` when given (a tensor autograd may follow), else the
    system's own geometry on ``device``."""
    return _t(system.positions, device) if positions is None else positions


def _assemble(system: MolecularSystem, class_fn, device, positions=None) -> torch.Tensor:
    nao = system.n_basis_cart()
    positions = _positions(system, device, positions)
    out = torch.zeros((nao, nao), dtype=torch.float64, device=device)
    classes = system.shell_classes
    for la, ca in classes.items():
        for lb, cb in classes.items():
            ia, ib, a, b, cc, A, B, AB = _pair_batch(ca, cb, positions)
            block = class_fn(la, lb, a, b, cc, A, B, AB, positions)
            rows = ca.ao_offsets[ia][:, None, None] + np.arange(ncart(la))[None, :, None]
            cols = cb.ao_offsets[ib][:, None, None] + np.arange(ncart(lb))[None, None, :]
            out[torch.as_tensor(rows, device=device), torch.as_tensor(cols, device=device)] = block
    norms = _t(system.ao_norms, device)
    out = out * norms[:, None] * norms[None, :]
    if system.spherical:
        T = _t(system.sph_T, device)
        out = T.T @ out @ T
    return out


def overlap(system: MolecularSystem, device, positions=None) -> torch.Tensor:
    """Full AO overlap matrix S (nao, nao), nao of the working basis."""
    return _assemble(
        system,
        lambda la, lb, a, b, cc, A, B, AB, pos: _overlap_class(la, lb, a, b, cc, AB),
        device,
        positions,
    )


def kinetic(system: MolecularSystem, device, positions=None) -> torch.Tensor:
    """Full AO kinetic-energy matrix T (nao, nao)."""
    return _assemble(
        system,
        lambda la, lb, a, b, cc, A, B, AB, pos: _kinetic_class(la, lb, a, b, cc, AB),
        device,
        positions,
    )


def nuclear(system: MolecularSystem, device, positions=None) -> torch.Tensor:
    """Full AO nuclear-attraction matrix V (nao, nao)."""
    charges = _t(system.charges, device)
    return _assemble(
        system,
        lambda la, lb, a, b, cc, A, B, AB, pos: _nuclear_class(
            la, lb, a, b, cc, A, B, AB, charges, pos
        ),
        device,
        positions,
    )


def _moment_class(d: int, la, lb, a, b, cc, A, B, AB):
    """<i| r_d |j> for one class pair (Cartesian moment about the origin):
    in dimension d, <x^i | x | x^j> = E^{ij}_1 + P_x E^{ij}_0 (the t = 1
    Hermite coefficient plus the Gaussian-product centre); the other two
    dimensions are plain overlaps."""
    p = a + b
    P = (a[..., None] * A[:, None, None, :] + b[..., None] * B[:, None, None, :]) / p[..., None]
    es = e_cubes(la, lb, a, b, AB)
    pref = (math.pi / p) ** 1.5 * cc

    def dim(e, i, j, moment):
        s0 = e[..., i, j, 0]
        if not moment:
            return s0
        e1 = e[..., i, j, 1] if e.shape[-1] > 1 else torch.zeros_like(s0)
        return e1 + P[..., d] * s0

    blocks = []
    for ca in cart_components(la):
        row = []
        for cb in cart_components(lb):
            s = 1.0
            for dd in range(3):
                s = s * dim(es[dd], ca[dd], cb[dd], moment=(dd == d))
            row.append(torch.sum(pref * s, dim=(-1, -2)))
        blocks.append(torch.stack(row, dim=-1))
    return torch.stack(blocks, dim=-2)


def dipole_integrals(system: MolecularSystem, device) -> torch.Tensor:
    """Cartesian moment matrices <i| r |j>, shape (3, nao, nao), origin 0,
    nao of the working basis."""
    return torch.stack([
        _assemble(
            system,
            lambda la, lb, a, b, cc, A, B, AB, pos, d=d: _moment_class(d, la, lb, a, b, cc, A, B, AB),
            device,
        )
        for d in range(3)
    ])
