"""Kernel 2: the in-core Fock matvec G = terms @ vec(D),
``csrc/fock_matvec.cu``, beside its plain PyTorch twin ``terms @ d``.

Every in-core SCF pass is one product of the (m, m) symmetric RHF operator
terms (m = n^2) with the flattened density. Replaces the TPU kernel
``qchem_rs_tpu/ops/fock_matvec.py::_kernel`` (:82, reached through
``matvec_df`` :108), which needed a (hi, lo)-f32 split of terms, Dekker
products and a tree reduction because the TPU has no f64. The H100 has
native FP64, so the port keeps terms as one f64 matrix with no split and no
padding.

What bounds it on the H100: device-memory bandwidth, 2 FLOPs per 8-byte
element. terms is symmetric (``finish_terms`` gathers both halves from the
mirrored V2, so it is symmetric to rounding; tests/test_torch_eri.py holds
it to 1e-15 of its largest entry), so the
kernel reads only the 64 x 64 blocks on and above the diagonal and uses
each off-diagonal block twice, G_I += B d_J and G_J += B^T d_I: half the
bytes of a full read (0.83 GB instead of 1.66 GB at benzene/cc-pVDZ,
m = 14400). Each warp owns whole blocks of a persistent grid and streams
them with L1-bypassing loads. There are no atomics: each block writes its
row and column sums into slots of its own in a scratch matrix P
(``partials_plain`` shows the layout), and a second kernel adds P's rows
in a fixed order, so G repeats bit for bit from run to run.

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
    [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_void_p],
)


#: block edge of the kernel's half read
BLOCK = 64


def matvec_plain(terms: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """The twin: terms @ d."""
    return terms @ d


def matvec_upper_plain(terms: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """What the kernel computes for any square ``terms``: the product with
    its block upper triangle (BLOCK x BLOCK blocks on and above the
    diagonal) mirrored. Equal to ``matvec_plain`` for a symmetric terms."""
    m = terms.shape[0]
    blk = torch.arange(m, device=terms.device) // BLOCK
    below = blk[:, None] > blk[None, :]  # blocks strictly below the diagonal
    return torch.where(below, terms.T, terms) @ d


def partials_plain(terms: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """The kernel's scratch matrix P (nb, m), nb = ceil(m / BLOCK), for any
    square ``terms``: block (I, J), J > I, of the block upper triangle puts
    B^T d_I in row I at J's columns and B d_J in row J at I's columns; a
    diagonal block puts B d_I in row I at I's columns. Every slot is
    written once, and ``P.sum(0)`` is ``matvec_upper_plain``: the kernel
    adds the rows in a fixed order (K = s, s + 8, ... per slice s, then the
    8 slices in turn)."""
    m = terms.shape[0]
    nb = -(-m // BLOCK)
    P = torch.full((nb, m), float("nan"), dtype=terms.dtype, device=terms.device)
    for i in range(nb):
        ri = slice(i * BLOCK, min(m, (i + 1) * BLOCK))
        for j in range(i, nb):
            rj = slice(j * BLOCK, min(m, (j + 1) * BLOCK))
            B = terms[ri, rj]
            P[j, ri] = B @ d[rj]
            if j != i:
                P[i, rj] = B.T @ d[ri]
    return P


def matvec(terms: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """G = terms @ d for a symmetric square float64 ``terms`` (m, m) and
    ``d`` (m,).

    Precondition: terms is symmetric. The kernel reads only the block upper
    triangle and computes the product with it mirrored
    (``matvec_upper_plain``); checking symmetry would read the whole matrix,
    so the wrapper does not. The main path's terms is symmetric to rounding
    (tests/test_torch_eri.py shows it)."""
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
    m = terms.shape[0]
    part = torch.empty((-(-m // BLOCK), m), dtype=torch.float64, device=dev)
    g = torch.empty(m, dtype=torch.float64, device=dev)
    with torch.cuda.device(dev):
        KERNEL.launch(m, terms.data_ptr(), d.data_ptr(), part.data_ptr(), g.data_ptr(),
                      stream_of(g))
    return g
