"""Schwarz screening bounds (port of ``qchem_rs_tpu/ops/fock.py:26-39``).

q_P = sqrt(max_component (P|P)) per shell pair; the tiled pair-space engine
(``ops/eri_tiled.py``) sorts pairs by these and skips tile blocks whose
bound product falls below the screening threshold.
"""

from __future__ import annotations

import numpy as np
import torch

from qchem_rs_tpu_torch.ops.eri import PairGroup, _eri_chunk_core

#: pairs per batch of diagonal (P|P) blocks: bounds the (H, n, a, a)
#: R table of the highest classes
_CHUNK = 256


def schwarz_bounds(groups: list[PairGroup]) -> list[np.ndarray]:
    """q_P per pair, per group, as host numpy arrays."""
    out = []
    for g in groups:
        qs = []
        for s in range(0, g.npairs, _CHUNK):
            sl = slice(s, s + _CHUNK)
            E, p, P = g.E[sl], g.p[sl], g.P[sl]
            vals = _eri_chunk_core(g.L, g.L, E, p, P, E, p, P)  # (n, A, A)
            qs.append(torch.diagonal(vals, dim1=1, dim2=2).abs().amax(dim=1))
        out.append(np.sqrt(torch.cat(qs).cpu().numpy()))
    return out
