"""qchem_rs_tpu_torch: the Hartree-Fock engine of ``qchem_rs_tpu`` and its
first post-HF rung ported to PyTorch, with its TPU kernels rewritten as
hand-written CUDA kernels for NVIDIA Hopper (``csrc/``).

The port covers RHF and UHF: basis and molecule loading, one-electron
integrals (S, T, V and the dipole matrices), the Schwarz-screened
pair-space ERI build (kernel 1, ``ops/eri_kernel.py``), three Fock modes
(the in-core operator, whose per-pass matvec is kernel 2
(``ops/fock_matvec.py``); the pair-space matrices of ``ops/fock_pair.py``,
whose Coulomb product is kernel 2; the integral-direct
``ops/fock_stream.py``, which runs kernel 1 at every pass), the Hückel or
SAD guess, level shifting and uniform external fields; the dipole moment,
Mulliken charges and <S^2> (``models/properties.py``); SCF checkpoints
(``utils/checkpoint.py``, the JAX package's ``.npz`` keys); MP2 and UMP2
in core and in pair space (``models/mp2.py``); the correlated tier past
it: CCSD(T) and UCCSD(T) (``models/cc.py``), CIS/TDHF/UCIS
(``models/cis.py``), FCI (``models/fci.py``), EOM-CCSD (``models/eom.py``)
and the CC Lambda and relaxed dipoles (``models/cc_lambda.py``,
``models/cc_relaxed.py``); the gradient and geometry tier: analytic RHF
and UHF nuclear gradients (``models/gradients.py``, with the derivative
integrals segment by segment in pair space, ``models/gradients_pair.py``),
geometry optimization (``models/optimize.py``), harmonic frequencies
(``models/hessian.py``), RRHO thermochemistry (``models/thermo.py``) and
static and dynamic polarizabilities (``models/response.py``); the
multi-device tier over ``torch.distributed`` (``parallel/``: the process
mesh, the sharded direct, pair-space and column-sharded Fock builders,
sharded MP2, conformer and chained sweeps); and the ``rhf`` (with
``--gradient`` and ``--polarizability``), ``uhf``, ``mp2``, ``ccsd``,
``fci``, ``eom``, ``cis``, ``optimize``, ``frequencies``, ``sweep`` and
``info`` subcommands of the CLI. Everything is float64, and the SCF,
CCSD(T) and the nuclear gradient repeat bit for bit on the same inputs.
Every entry point takes an explicit ``device``; CPU tensors run each
kernel's plain PyTorch twin. The package never imports JAX.
"""

from qchem_rs_tpu_torch.config import HartreeFockConfig
from qchem_rs_tpu_torch.models.cis import cis, ucis
from qchem_rs_tpu_torch.models.gradients import (rhf_energy_and_gradient, rhf_gradient,
                                                 scf_and_gradient, uhf_gradient)
from qchem_rs_tpu_torch.models.gradients_pair import rhf_gradient_pair, uhf_gradient_pair
from qchem_rs_tpu_torch.models.hessian import HarmonicResult, harmonic_frequencies, hessian_fd
from qchem_rs_tpu_torch.models.mp2 import Mp2Output, mp2, mp2_pair_space, ump2, ump2_pair_space
from qchem_rs_tpu_torch.models.optimize import OptimizationResult, optimize_geometry
from qchem_rs_tpu_torch.models.properties import dipole_moment, mulliken_charges, spin_expectation
from qchem_rs_tpu_torch.models.response import dynamic_polarizability, static_polarizability
from qchem_rs_tpu_torch.models.rhf import RestrictedHartreeFockOutput, restricted_hartree_fock
from qchem_rs_tpu_torch.models.thermo import ThermoOutput, thermochemistry
from qchem_rs_tpu_torch.models.uhf import UnrestrictedHartreeFockOutput, unrestricted_hartree_fock
from qchem_rs_tpu_torch.utils.basis import BasisSet
from qchem_rs_tpu_torch.utils.checkpoint import ScfCheckpoint
from qchem_rs_tpu_torch.utils.system import Atom, MolecularSystem

__all__ = [
    "Atom",
    "BasisSet",
    "HarmonicResult",
    "HartreeFockConfig",
    "MolecularSystem",
    "Mp2Output",
    "OptimizationResult",
    "RestrictedHartreeFockOutput",
    "ScfCheckpoint",
    "ThermoOutput",
    "UnrestrictedHartreeFockOutput",
    "cis",
    "dipole_moment",
    "dynamic_polarizability",
    "harmonic_frequencies",
    "hessian_fd",
    "mp2",
    "mp2_pair_space",
    "mulliken_charges",
    "optimize_geometry",
    "restricted_hartree_fock",
    "rhf_energy_and_gradient",
    "rhf_gradient",
    "rhf_gradient_pair",
    "scf_and_gradient",
    "spin_expectation",
    "static_polarizability",
    "thermochemistry",
    "ucis",
    "uhf_gradient",
    "uhf_gradient_pair",
    "ump2",
    "ump2_pair_space",
    "unrestricted_hartree_fock",
]
