"""Kernel 2: the in-core Fock matvec G = terms @ vec(D),
``csrc/fock_matvec.cu``, beside its plain PyTorch twin ``terms @ d``.

Every in-core SCF pass is one product of the (m, m) symmetric RHF operator
terms (m = n^2) with the flattened density. Replaces the TPU kernel
``qchem_rs_tpu/ops/fock_matvec.py::_kernel`` (:82, reached through
``matvec_df`` :108), which needed a (hi, lo)-f32 split of terms, Dekker
products and a tree reduction because the TPU has no f64. The H100 has
native FP64, so the port keeps terms as one f64 matrix with no split and no
padding.

What bounds it on the H100: device-memory bandwidth. It reads all of terms
once per pass (benzene/cc-pVDZ: m = 14400, 1.66 GB) for 2 FLOPs per 8
bytes. The design streams each row exactly once: one warp per output row,
16-byte (double2) loads along the row (8-byte loads when the row length is
odd), each lane keeping a partial sum, then a warp-shuffle reduction. The
vector d (115 KB at benzene) stays in L2/L1 for all warps.

On CPU tensors ``matvec`` runs the twin; on CUDA tensors it launches the
kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from qchem_rs_tpu_torch.utils.cuda import CudaKernel, stream_of

KERNEL = CudaKernel(
    "fock_matvec.cu",
    "fock_matvec",
    [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p],
)


def matvec_plain(terms: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """The twin: terms @ d."""
    return terms @ d


def matvec(terms: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """G = terms @ d for square float64 ``terms`` (m, m) and ``d`` (m,)."""
    if terms.dtype != torch.float64 or d.dtype != torch.float64:
        raise TypeError(f"matvec needs float64, got {terms.dtype} and {d.dtype}")
    if terms.ndim != 2 or terms.shape[0] != terms.shape[1] or d.shape != (terms.shape[0],):
        raise ValueError(f"shapes terms {tuple(terms.shape)}, d {tuple(d.shape)}")
    if terms.device != d.device:
        raise ValueError(f"terms on {terms.device}, d on {d.device}")
    if not (terms.is_contiguous() and d.is_contiguous()):
        raise ValueError("terms and d must be contiguous")
    dev = terms.device
    if dev.type == "cpu":
        return matvec_plain(terms, d)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if terms.data_ptr() % 16 or d.data_ptr() % 16:
        raise ValueError("terms and d must be 16-byte aligned")
    m = terms.shape[0]
    g = torch.empty(m, dtype=torch.float64, device=dev)
    with torch.cuda.device(dev):
        KERNEL.launch(m, terms.data_ptr(), d.data_ptr(), g.data_ptr(), stream_of(g))
    return g
