"""Molecule and basis, read from the files themselves.

Molecule files are lists of ``{"element": "<Z>", "position": [x, y, z]}``
in Bohr; basis files are MolSSI BSE JSON ("complete" schema). Every
Cartesian AO is a contracted Gaussian normalised to unit self-overlap, in
this order: atoms as listed, each atom's shells as the basis file lists
them (a fused ``[0, 1]`` entry gives an s and then a p shell, a general
contraction one shell per coefficient list), and within a shell the
Cartesian powers with lx descending, then ly descending. Primitives whose
coefficient is zero are dropped.
"""

from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path

import numpy as np


def double_factorial(n: int) -> int:
    """n!! with (-1)!! = 0!! = 1."""
    return math.prod(range(n, 0, -2)) if n > 0 else 1


def cartesian_powers(l: int) -> list[tuple[int, int, int]]:
    """The (lx, ly, lz) of a shell of angular momentum l, in AO order."""
    return [(lx, ly, l - lx - ly) for lx in range(l, -1, -1) for ly in range(l - lx, -1, -1)]


def component_factors(l: int) -> np.ndarray:
    """Per-component factors that give x^i y^j z^k unit norm when the
    contraction is normalised for x^l."""
    d = double_factorial(2 * l - 1)
    return np.array([math.sqrt(d / (double_factorial(2 * i - 1) * double_factorial(2 * j - 1)
                                    * double_factorial(2 * k - 1)))
                     for i, j, k in cartesian_powers(l)])


@dataclasses.dataclass(frozen=True)
class Shell:
    l: int
    atom: int
    exponents: np.ndarray  # (K,)
    coefficients: np.ndarray  # (K,) with the primitive norms of x^l folded in
    ao: int  # first AO


def _normalised(l: int, exps: np.ndarray, coefs: np.ndarray) -> np.ndarray:
    d = double_factorial(2 * l - 1)
    c = coefs * (2 * exps / math.pi) ** 0.75 * (4 * exps) ** (l / 2) / math.sqrt(d)
    ap = exps[:, None] + exps[None, :]
    overlap = (math.pi / ap) ** 1.5 * d / (2 * ap) ** l
    return c / math.sqrt(c @ overlap @ c)


def read_basis(path: str | Path) -> dict[int, list[tuple[int, np.ndarray, np.ndarray]]]:
    """Element -> [(l, exponents, raw coefficients)] in file order."""
    data = json.loads(Path(path).read_text())
    out = {}
    for element, record in data["elements"].items():
        shells = []
        for entry in record["electron_shells"]:
            exps = np.array([float(x) for x in entry["exponents"]])
            ls = list(entry["angular_momentum"])
            lists = entry["coefficients"]
            if len(ls) == 1:
                ls = ls * len(lists)
            if len(ls) != len(lists):
                raise ValueError(f"element {element}: {ls} against {len(lists)} coefficient lists")
            for l, raw in zip(ls, lists):
                c = np.array([float(x) for x in raw])
                keep = c != 0.0
                if keep.any():
                    shells.append((int(l), exps[keep], c[keep]))
        out[int(element)] = shells
    return out


def read_molecule(path: str | Path) -> tuple[np.ndarray, np.ndarray]:
    """(atomic numbers (natom,), positions (natom, 3) in Bohr)."""
    atoms = json.loads(Path(path).read_text())
    z = np.array([int(a["element"]) for a in atoms], dtype=np.int64)
    x = np.array([a["position"] for a in atoms], dtype=np.float64)
    return z, x


class Molecule:
    """Atoms at ``positions`` (Bohr) with the basis's shells on them."""

    def __init__(self, numbers: np.ndarray, positions: np.ndarray, basis: dict):
        self.numbers = np.asarray(numbers, dtype=np.int64)
        self.positions = np.asarray(positions, dtype=np.float64).reshape(-1, 3)
        shells, ao = [], 0
        for atom, z in enumerate(self.numbers):
            for l, exps, coefs in basis[int(z)]:
                shells.append(Shell(l, atom, exps, _normalised(l, exps, coefs), ao))
                ao += (l + 1) * (l + 2) // 2
        self.shells = shells
        self.nao = ao

    def n_occupied(self, charge: int = 0) -> int:
        n = int(self.numbers.sum()) - charge
        if n % 2:
            raise ValueError(f"{n} electrons: not a closed shell")
        return n // 2

    def nuclear_repulsion(self) -> float:
        e = 0.0
        for i in range(len(self.numbers)):
            for j in range(i):
                e += self.numbers[i] * self.numbers[j] / np.linalg.norm(self.positions[i] - self.positions[j])
        return float(e)
