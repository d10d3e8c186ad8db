"""MolSSI BSE JSON basis-set parser (copy of ``qchem_rs_tpu/utils/basis.py``).

Parses the bundled ``data/basis`` files ("complete" schema v0.1): per-element
``electron_shells`` records with ``function_type: "gto"``, string-encoded
``exponents``, ``angular_momentum`` lists that may be fused (e.g. ``[0, 1]``
sp shells in STO-3G), and one coefficient list per angular momentum.

Fused sp shells are split into separate s and p shells sharing exponents —
the shell classes downstream are grouped by a single angular momentum l.
numpy only: the port's host layer never imports the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np

MAX_L = 4  # g functions; bundled bases reach l=3 (f)

ANGULAR_NAMES = "spdfg"


@dataclasses.dataclass(frozen=True)
class ShellSpec:
    """One contracted shell of a single angular momentum, as read from the
    basis file (coefficients refer to normalized primitives, per BSE schema)."""

    l: int
    exponents: np.ndarray  # (K,) float64
    coefficients: np.ndarray  # (K,) float64


class BasisSet:
    """A parsed basis set: element ordinal -> list of ShellSpec."""

    def __init__(self, name: str, shells_by_element: dict[int, list[ShellSpec]]):
        self.name = name
        self._shells = shells_by_element

    @classmethod
    def load(cls, path: str | Path) -> "BasisSet":
        path = Path(path)
        with open(path) as f:
            data = json.load(f)
        schema = data.get("molssi_bse_schema", {})
        if schema.get("schema_type") not in (None, "complete"):
            raise ValueError(
                f"unsupported basis schema {schema.get('schema_type')!r} in {path}"
            )
        shells_by_element: dict[int, list[ShellSpec]] = {}
        for elem_str, record in data.get("elements", {}).items():
            ordinal = int(elem_str)
            shells: list[ShellSpec] = []
            for shell in record.get("electron_shells", []):
                ftype = shell.get("function_type", "gto")
                if not ftype.startswith("gto"):
                    raise ValueError(f"unsupported function_type {ftype!r} in {path}")
                exps = np.array([float(x) for x in shell["exponents"]], dtype=np.float64)
                ls = shell["angular_momentum"]
                coef_lists = shell["coefficients"]
                if len(ls) == 1 and len(coef_lists) > 1:
                    # general contraction (e.g. cc-pVDZ s block): one l, many
                    # contracted functions sharing the exponent list
                    ls = ls * len(coef_lists)
                if len(ls) != len(coef_lists):
                    raise ValueError(
                        f"angular_momentum/coefficients mismatch for element "
                        f"{ordinal} in {path}: {ls} vs {len(coef_lists)} lists"
                    )
                for l, coefs in zip(ls, coef_lists):
                    if l > MAX_L:
                        raise ValueError(f"angular momentum l={l} not supported")
                    c = np.array([float(x) for x in coefs], dtype=np.float64)
                    nz = c != 0.0
                    # drop zero-coefficient primitives (common in general
                    # contractions) to keep contraction classes tight
                    if not nz.any():
                        continue
                    shells.append(ShellSpec(l=int(l), exponents=exps[nz], coefficients=c[nz]))
            shells_by_element[ordinal] = shells
        name = data.get("name") or path.stem
        return cls(name, shells_by_element)

    def shells_for(self, ordinal: int) -> list[ShellSpec]:
        try:
            return self._shells[ordinal]
        except KeyError:
            raise KeyError(
                f"basis set {self.name!r} has no element with ordinal {ordinal}"
            ) from None

    def elements(self) -> list[int]:
        return sorted(self._shells)

    def __repr__(self) -> str:
        return f"BasisSet({self.name!r}, {len(self._shells)} elements)"
