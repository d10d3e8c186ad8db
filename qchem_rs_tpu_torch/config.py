"""Run configuration (copy of ``qchem_rs_tpu/config.py``).

Mirrors the reference's ``HartreeFockConfig { max_iterations, epsilon }``
(qchem-rs core/src/hf/mod.rs:9-15) and extends it with the knobs the
reference hard-codes: DIIS window (rhf.rs:65), density mixing (rhf.rs:80-82),
convergence metric (rhf.rs:87-88), charge / spin multiplicity and the
screening threshold. The port honours the subset its in-core RHF path runs
(``models/rhf.py`` rejects the rest with NotImplementedError).
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class HartreeFockConfig:
    #: maximum number of SCF iterations. NOTE the reference iterates
    #: ``0..=max_iterations`` (rhf.rs:66), i.e. max_iterations+1 passes; the
    #: port reproduces that bound for parity.
    max_iterations: int = 100
    #: convergence threshold on the density RMS (reference default 1e-6).
    epsilon: float = 1e-6
    #: convergence metric. "diag_rms" reproduces the reference quirk of using
    #: only the diagonal of the density change (rhf.rs:87-88); "full_rms" uses
    #: the full-matrix RMS. Both reach the same fixed point; only the stopping
    #: iteration differs.
    convergence_metric: str = "diag_rms"
    #: density mixing factor; reference uses 1.0 i.e. no damping (rhf.rs:80).
    mixing_factor: float = 1.0
    #: DIIS window (min history before extrapolation kicks in, max history
    #: kept). Reference: RHF Diis::new(4, 6) (rhf.rs:65). None selects the
    #: per-method defaults.
    diis_min: Optional[int] = None
    diis_max: Optional[int] = None
    #: total molecular charge.
    charge: int = 0
    #: spin multiplicity 2S+1; 0 means "reference-compatible".
    spin_multiplicity: int = 0
    #: Schwarz screening threshold for pair tiles (0 disables).
    screening_threshold: float = 1e-12
    #: "incore" materializes the RHF operator once; "pair" and "direct" are
    #: not ported yet.
    fock_mode: str = "incore"
    #: per-iteration SCF logging
    verbose: bool = False
    #: initial density guess: "huckel" (rhf.rs:133-150); "sad" is not ported
    #: yet.
    initial_guess: str = "huckel"
    #: level shift sigma (Hartree) added to the virtual-virtual block of the
    #: orthogonal-basis Fock matrix; 0 disables. Not ported yet.
    level_shift: float = 0.0
    #: uniform external electric field (a.u.); not ported yet.
    electric_field: tuple[float, float, float] = (0.0, 0.0, 0.0)

    def diis_window(self, default_min: int, default_max: int) -> tuple[int, int]:
        return (
            self.diis_min if self.diis_min is not None else default_min,
            self.diis_max if self.diis_max is not None else default_max,
        )
