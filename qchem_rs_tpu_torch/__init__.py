"""qchem_rs_tpu_torch: the Hartree-Fock engine of ``qchem_rs_tpu`` ported to
PyTorch, with its TPU kernels rewritten as hand-written CUDA kernels for
NVIDIA Hopper (``csrc/``).

This slice covers the in-core RHF path: basis and molecule loading, one-
electron integrals, the Schwarz-screened pair-space ERI build (kernel 1,
``ops/eri_kernel.py``), the RHF operator, and the SCF loop whose per-pass
Fock matvec is kernel 2 (``ops/fock_matvec.py``). Everything is float64.
Every entry point takes an explicit ``device``; CPU tensors run each
kernel's plain PyTorch twin. The package never imports JAX.
"""

from qchem_rs_tpu_torch.config import HartreeFockConfig
from qchem_rs_tpu_torch.models.rhf import RestrictedHartreeFockOutput, restricted_hartree_fock
from qchem_rs_tpu_torch.utils.basis import BasisSet
from qchem_rs_tpu_torch.utils.system import Atom, MolecularSystem

__all__ = [
    "Atom",
    "BasisSet",
    "HartreeFockConfig",
    "MolecularSystem",
    "RestrictedHartreeFockOutput",
    "restricted_hartree_fock",
]
