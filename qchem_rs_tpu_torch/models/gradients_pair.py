"""The two-electron part of the analytic nuclear gradient, in the pair
space of the tiled ERI engine (port of
``qchem_rs_tpu/models/gradients_pair.py``): no n^4 tensor anywhere.

With the densities frozen, the two-electron energy over the mirrored pair
matrix V2f (row P = AO pair (a_P, b_P); J weights w_P and exchange
weights u_P, zero on padding and redundant rows) is

    E_2e = sum_{P,Q} V2f[P, Q] Z[P, Q],
    Z    = 1/2 dJ_P dJ_Q - sum_sigma u_P u_Q (D^s[a_P, a_Q] D^s[b_P, b_Q]
                                              + D^s[a_P, b_Q] D^s[b_P, a_Q]),

dJ_P = w_P D[a_P, b_P] of the total density (exchange couples same-spin
densities only; a closed shell passes D/2 for both spins). Summed over
the engine's tiles, strictly-upper tiles count twice (V2f is symmetric and
the engine builds upper blocks) and diagonal tiles once.

The derivative of E_2e in the nuclear positions goes through the tile
values of ``eri_kernel.bra_tiles_plain`` and ``eri_tiled.ket_contract``,
the torch f64 form of kernel 1's chain, by torch autograd. These are the
derivative integrals: like the JAX package's, which run its XLA
``_tile_vals`` because Mosaic kernels define no VJP, they are plain
framework code outside any hand-written kernel. They are called by name,
only here; kernel 1 and its ``bra_tiles`` contract are untouched, and
every energy the gradient needs comes from kernels 1 and 2.

The work goes segment by segment (the counterpart of ``jax.checkpoint``
over the JAX package's scan): each segment is a batch of one class pair's
tiles, sized by ``SEGMENT_BYTES``, over its tiles' real primitive pairs
only (the engine's classes list them first); autograd takes the gradient of the
segment's energy with respect to the two classes' padded operands (E and
the product centres P) and drops its graph at once, and the operands'
gradients add up class by class in a fixed order. One last backward pass
carries them to the positions through ``TiledEriEngine.padded_at``. The
R tables' derivative comes from one table at L + 1 (``mcmurchie._HermiteR``),
so autograd never runs through the recursion or the Boys function.

On CUDA the backward of a gather adds with the sort-based deterministic
kernels (``deterministic``), so the gradient repeats bit for bit.
"""

from __future__ import annotations

import contextlib
import warnings
from typing import Optional

import numpy as np
import torch

from qchem_rs_tpu_torch.config import HartreeFockConfig
from qchem_rs_tpu_torch.ops.eri_kernel import bra_tiles_plain, ket_contract
from qchem_rs_tpu_torch.ops.eri_tiled import TiledEriEngine
from qchem_rs_tpu_torch.ops.fock_pair import pair_row_ao
from qchem_rs_tpu_torch.ops.mcmurchie import nhermite
from qchem_rs_tpu_torch.utils.system import MolecularSystem

#: bytes one gradient segment may hold on a card: its R tables at L + 1,
#: the (s1, s2) gather and its gradient, and their temporaries
SEGMENT_BYTES = 1 << 32
#: the same on the CPU, where the port's tests run small systems
SEGMENT_BYTES_CPU = 1 << 28


@contextlib.contextmanager
def deterministic():
    """Run the block with torch's deterministic algorithms: on CUDA the
    backward of a gather then adds by sorted index in a fixed order rather
    than with atomics. cuBLAS on one stream is deterministic already, so
    its warning is silenced; uninitialised memory is not filled."""
    enabled = torch.are_deterministic_algorithms_enabled()
    warn_only = torch.is_deterministic_algorithms_warn_only_enabled()
    det = torch.utils.deterministic
    fill = det.fill_uninitialized_memory
    torch.use_deterministic_algorithms(True, warn_only=True)
    det.fill_uninitialized_memory = False
    try:
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", message=".*CuBLAS.*")
            yield
    finally:
        torch.use_deterministic_algorithms(enabled, warn_only=warn_only)
        det.fill_uninitialized_memory = fill


def _pair_weights(layout, nao: int):
    """(wj, u, ra, rb, pidx) host arrays over the M pair rows: the J and
    exchange weights, each row's AO indices and its flat AO-pair index."""
    row_i, row_j, dup = pair_row_ao(layout)
    pad = row_i < 0
    ci = np.where(pad, 0, row_i)
    cj = np.where(pad, 0, row_j)
    dead = pad | dup
    wj = np.where(dead, 0.0, np.where(ci == cj, 1.0, 2.0))
    u = np.where(dead, 0.0, np.where(ci == cj, 0.5, 1.0))
    return wj, u, ci, cj, ci * nao + cj


def segment_tile_bytes(m1, m2) -> int:
    """Bytes one tile of class pair (m1, m2) holds in a gradient segment:
    per primitive quartet, the R table at L + 1 (and two temporaries of
    its size while it is built), the (s1, s2) gather and its gradient, and
    four tables at L in the backward."""
    L = m1.la + m1.lb + m2.la + m2.lb
    S1, S2 = nhermite(m1.la + m1.lb), nhermite(m2.la + m2.lb)
    units = 3 * nhermite(L + 1) + 2 * S1 * S2 + 4 * nhermite(L) + 16
    return 8 * units * m1.tile * m2.tile * m1.a * m2.a


class PairGradientProgram:
    """The two-electron gradient over one engine's tiles.

        prog = PairGradientProgram(engine)
        g = prog(Ds, weights)   # (natom, 3) tensor

    ``Ds`` (ns, ncart, ncart) are frozen per-spin Cartesian densities and
    ``weights`` how many spins each stands for: a closed shell passes
    (D/2,) with (2.0,), UHF (D_alpha, D_beta) with (1.0, 1.0).
    """

    def __init__(self, engine: TiledEriEngine):
        self.engine = engine
        dev = engine.device
        segment_bytes = SEGMENT_BYTES if dev.type == "cuda" else SEGMENT_BYTES_CPU
        wj, u, ra, rb, pidx = _pair_weights(engine.layout, engine.nao)
        f64 = lambda x: torch.as_tensor(x, dtype=torch.float64, device=dev)  # noqa: E731
        i64 = lambda x: torch.as_tensor(x, dtype=torch.long, device=dev)  # noqa: E731
        self._wj, self._u = f64(wj), f64(u)
        self._ra, self._rb, self._pidx = i64(ra), i64(rb), i64(pidx)
        #: real primitive pairs per pair, per class (they come first)
        self._nprim = [c.n.cpu().numpy() for c in engine._counts]
        metas = engine.layout.metas
        #: (i1, i2, ti, tj) per segment, in the engine's task order
        self.segments = []
        for i1, i2, ti, tj in engine._tasks:
            step = max(1, segment_bytes // segment_tile_bytes(metas[i1], metas[i2]))
            for s in range(0, len(ti), step):
                self.segments.append((i1, i2, ti[s : s + step], tj[s : s + step]))

    def _z(self, spins, dJ, i1, i2, ti, tj) -> torch.Tensor:
        """The segment's Z (nt, T1*A, T2*C), rows and columns in the tile
        values' order."""
        m1, m2 = self.engine.layout.metas[i1], self.engine.layout.metas[i2]
        dev = dJ.device
        rows = torch.as_tensor(m1.row_base + ti[:, None] * m1.A + np.arange(m1.tile * m1.A),
                               device=dev)
        cols = torch.as_tensor(m2.row_base + tj[:, None] * m2.A + np.arange(m2.tile * m2.A),
                               device=dev)
        Z = 0.5 * dJ[rows][:, :, None] * dJ[cols][:, None, :]
        uu = self._u[rows][:, :, None] * self._u[cols][:, None, :]
        ar, br = self._ra[rows][:, :, None], self._rb[rows][:, :, None]
        ac, bc = self._ra[cols][:, None, :], self._rb[cols][:, None, :]
        for D, w in spins:
            Z = Z - w * uu * (D[ar, ac] * D[br, bc] + D[ar, bc] * D[br, ac])
        return Z

    def operand_grads(self, Ds, weights):
        """d E_2e / d (E, P) of every class, by segments: two lists of
        tensors shaped as the engine's padded E and P."""
        eng = self.engine
        metas = eng.layout.metas
        spins = list(zip(Ds, weights))
        Dt = sum(w * D for D, w in spins)
        dJ = Dt.reshape(-1)[self._pidx] * self._wj
        gE = [torch.zeros_like(E) for E, _, _ in eng._padded]
        gP = [torch.zeros_like(P) for _, _, P in eng._padded]
        for i1, i2, ti, tj in self.segments:
            m1, m2 = metas[i1], metas[i2]
            # only the segment's real primitive pairs: its tiles' largest count
            a = max(1, int(self._nprim[i1][ti[:, None] + np.arange(m1.tile)].max()))
            c = max(1, int(self._nprim[i2][tj[:, None] + np.arange(m2.tile)].max()))
            E1, p1, P1 = (t[:, :a] for t in eng._padded[i1])
            E2, p2, P2 = (t[:, :c] for t in eng._padded[i2])
            leaves = [t.detach().requires_grad_() for t in (E1, P1, E2, P2)]
            E1l, P1l, E2l, P2l = leaves
            bra = bra_tiles_plain(m1.la + m1.lb, m2.la + m2.lb, E1l, p1, P1l, p2, P2l,
                                  ti, tj, m1.tile, m2.tile)
            vals = ket_contract(bra, E2l, tj, m2.tile)
            del bra
            Z = self._z(spins, dJ, i1, i2, ti, tj)
            w = np.where(ti == tj, 1.0, 2.0) if i1 == i2 else np.full(len(ti), 2.0)
            w = torch.as_tensor(w, dtype=vals.dtype, device=vals.device)
            e = (vals * Z).sum(dim=(1, 2)) @ w
            del vals, Z
            g = torch.autograd.grad(e, leaves)
            gE[i1][:, :a] += g[0]
            gP[i1][:, :a] += g[1]
            gE[i2][:, :c] += g[2]
            gP[i2][:, :c] += g[3]
        return gE, gP

    def __call__(self, Ds, weights) -> torch.Tensor:
        eng = self.engine
        with torch.enable_grad(), deterministic():
            gE, gP = self.operand_grads(Ds, weights)
            pos = torch.as_tensor(eng.system.positions, dtype=torch.float64,
                                  device=eng.device).requires_grad_()
            padded = eng.padded_at(pos)
            outs = [t for E, _, P in padded for t in (E, P)]
            grads = [t for pair in zip(gE, gP) for t in pair]
            (g,) = torch.autograd.grad(outs, pos, grads)
        return g


def rhf_gradient_pair(
    system: MolecularSystem,
    config: Optional[HartreeFockConfig] = None,
    *,
    output=None,
    device="cuda",
    timings: Optional[dict] = None,
) -> np.ndarray:
    """Analytic d E_RHF / d positions with the pair-space Fock build,
    (natom, 3) Hartree/Bohr: what ``gradients.rhf_gradient`` gives in
    ``fock_mode="pair"``, with no n^4 tensor at any step (the SCF's, G0's
    and the derivative integrals' envelopes are all pair-space)."""
    import dataclasses

    from qchem_rs_tpu_torch.models.gradients import frozen_orbital_gradient

    config = config or HartreeFockConfig(epsilon=1e-10, max_iterations=200, fock_mode="pair")
    config = dataclasses.replace(config, fock_mode="pair")
    return frozen_orbital_gradient(system, config, False, output, device, timings)


def uhf_gradient_pair(
    system: MolecularSystem,
    config: Optional[HartreeFockConfig] = None,
    *,
    output=None,
    device="cuda",
    timings: Optional[dict] = None,
) -> np.ndarray:
    """Analytic d E_UHF / d positions with the pair-space Fock build: what
    ``gradients.uhf_gradient`` gives in ``fock_mode="pair"``."""
    import dataclasses

    from qchem_rs_tpu_torch.models.gradients import frozen_orbital_gradient

    config = config or HartreeFockConfig(epsilon=1e-10, max_iterations=300, fock_mode="pair")
    config = dataclasses.replace(config, fock_mode="pair")
    return frozen_orbital_gradient(system, config, True, output, device, timings)
