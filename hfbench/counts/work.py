"""The work the Fock builds need, counted from their inputs, and the least
time one H100 could take for it.

A frozen copy of the port's operation model (``_quartet_flops`` and the
kernel counts of ``qchem_rs_tpu_torch/ops/eri_tiled.py``), counted at
shell-pair granularity: every unordered pair of shell pairs whose Schwarz
factors pass, q_AB q_CD > threshold, and within it every real primitive
quartet (primitive pairs whose Hermite expansion is not all zero). The
bra of a pair of shell pairs is the one whose class (la >= lb, classes in
ascending la, then lb) comes first, as the port orders class pairs. So the
count does not depend on tile edges, padding or the order the program
computes in.

- ``v2_build``: one in-core build's kernel-1 work: the bra half of the
  model over every real primitive quartet; the input E, p, P of every real
  primitive pair read once and every unique stored (ab|cd) written once.
- ``direct_pass``: one direct pass's kernel-3 work: the same plus the ket
  dot, 2 S2 A C per real ket primitive pair of each bra pair that has a
  real one; inputs as above and the density, outputs J and K.
"""

from __future__ import annotations

import dataclasses

import numpy as np

#: H100 SXM peaks: FP64 on the tensor cores (the chip's highest FP64
#: rate), and HBM3 bandwidth
FP64_PEAK_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12


def ncart(l: int) -> int:
    return (l + 1) * (l + 2) // 2


def nhermite(L: int) -> int:
    return (L + 1) * (L + 2) * (L + 3) // 6


def quartet_flops(L: int, S1: int, S2: int, A: int) -> float:
    """FLOPs of one primitive quartet in the bra half of the model: pair
    geometry, Boys, powers and prefactor, the R recursion, the (s1, s2)
    signs and the bra Hermite->Cartesian contraction."""
    H = nhermite(L)
    return (12.0 + (24.0 + 3.0 * L) + (2.0 * (L + 1) + 8.0) + (3.0 * H * L + 5.0 * H)
            + S1 * S2 + 2.0 * S1 * S2 * A)


@dataclasses.dataclass
class Work:
    flops: float
    bytes: float

    def least_s(self) -> float:
        return max(self.flops / FP64_PEAK_FLOPS, self.bytes / HBM_BYTES_PER_S)

    def __mul__(self, k: float) -> "Work":
        return Work(self.flops * k, self.bytes * k)


@dataclasses.dataclass
class PairClass:
    """The shell pairs of one class (la >= lb): Schwarz factor and number
    of real primitive pairs of each."""

    la: int
    lb: int
    q: np.ndarray
    nreal: np.ndarray


def classes(pairs) -> list[PairClass]:
    """Group (l1, l2, q, nreal) per shell pair into classes in the port's
    order."""
    out = {}
    for l1, l2, q, n in pairs:
        out.setdefault((max(l1, l2), min(l1, l2)), []).append((q, n))
    return [PairClass(la, lb, np.array([q for q, _ in v]), np.array([n for _, n in v], dtype=np.float64))
            for (la, lb), v in sorted(out.items())]


def _count(cls: list[PairClass], threshold: float, ket_dot: bool) -> tuple[float, float]:
    """(FLOPs, unique (ab|cd) values) over the kept pairs of shell pairs."""
    flops = values = 0.0
    for i1, c1 in enumerate(cls):
        for c2 in cls[i1:]:
            keep = (c1.q[:, None] * c2.q[None, :] > threshold).astype(np.float64)
            if c2 is c1:
                keep = np.triu(keep)
            Lb, Lk = c1.la + c1.lb, c2.la + c2.lb
            A, C, S2 = ncart(c1.la) * ncart(c1.lb), ncart(c2.la) * ncart(c2.lb), nhermite(Lk)
            flops += float(c1.nreal @ keep @ c2.nreal) * quartet_flops(Lb + Lk, nhermite(Lb), S2, A)
            if ket_dot:
                flops += float((c1.nreal > 0) @ keep @ c2.nreal) * 2.0 * S2 * A * C
            values += float(keep.sum()) * A * C
    return flops, values


def _inputs(cls: list[PairClass]) -> float:
    """Bytes of E, p and P over every real primitive pair."""
    return sum(8.0 * c.nreal.sum() * (ncart(c.la) * ncart(c.lb) * nhermite(c.la + c.lb) + 4)
               for c in cls)


def v2_build(cls: list[PairClass], threshold: float) -> Work:
    flops, values = _count(cls, threshold, ket_dot=False)
    return Work(flops, _inputs(cls) + 8.0 * values)


def direct_pass(cls: list[PairClass], threshold: float, nao: int) -> Work:
    flops, _ = _count(cls, threshold, ket_dot=True)
    return Work(flops, _inputs(cls) + 8.0 * 3 * nao * nao)


def fock_matvec(nao: int) -> Work:
    """One in-core pass: G = terms @ vec(D), terms (nao^2, nao^2)."""
    return Work(2.0 * nao ** 4, 8.0 * (nao ** 4 + 2 * nao ** 2))


def pair_classes(batches, schwarz) -> list[PairClass]:
    """Classes from the reference's shell-pair batches (``PairBatch``) and
    their Schwarz factors."""
    rows = []
    for b, q in zip(batches, schwarz):
        nreal = (b.E != 0).flatten(2).any(-1).sum(-1)
        rows += [(b.la, b.lb, float(x), int(n)) for x, n in zip(q.tolist(), nreal.tolist())]
    return classes(rows)
