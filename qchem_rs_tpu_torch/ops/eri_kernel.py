"""Kernel 1: the bra-contracted ERI tile, ``csrc/eri_tile.cu``, beside its
plain PyTorch twin.

For one class pair (bra pairs of total angular momentum Lb, ket pairs of
Lk) and a batch of pair tiles (row offsets ``ti`` into the bra class, column
offsets ``tj`` into the ket class), both compute

    out[tile, alpha, ic*S2 + s2, t1, t2]
        = sum_{ia, s1} E1[ti+t1, ia, alpha, s1] * sign[s2] * pref
                       * R[idx[s1, s2]](ia, ic, t1, t2)

where R is the Hermite Coulomb table of the primitive quartet (bra primitive
pair ia of pair ti+t1, ket primitive pair ic of pair tj+t2), pref =
2 pi^{5/2} / (pq sqrt(p+q)) and idx/sign the (s1, s2) plan of
``eri._r2_gather``. The ket contraction with E2 stays outside (a batched
matmul in ``eri_tiled.ket_contract``).

Replaces the three TPU kernels of ``qchem_rs_tpu/ops/eri_pallas.py``:
``_kernel_fused_e1`` (:205), ``_kernel_fused`` (:175) and ``_kernel_htab``
(:191). Those split the chain differently per class only because of VMEM
size and Mosaic's unroll limits; on the H100 one f64 kernel with runtime L
serves every class pair with L = Lb + Lk <= 8 (every class of d-shell bases
such as cc-pVDZ).

What bounds it on the H100: FP64 arithmetic and per-thread state. Each
thread owns one (tile, t1, t2, ic) point and loops over the bra primitive
pairs; per pair it evaluates Boys F_0..F_L, the R table (H <= 165 entries)
and the A*S2 bra-contracted sums of S1 products. At dd|dd the R table and
the products do not fit in registers, so R lives in thread-local memory
(L1-cached) and the sums accumulate straight into the output, which each
thread owns exclusively (no atomics). Reads of E1 and of the plans are
uniform across a warp (threads of a warp share t1), so they broadcast.
Making it fast (shared-memory R tables, FP64 tensor cores for the
contraction) is later work.

On CPU tensors ``bra_tiles`` runs the twin; on CUDA tensors it launches the
kernel or raises.
"""

from __future__ import annotations

import ctypes
import math
from functools import lru_cache

import numpy as np
import torch

from qchem_rs_tpu_torch.ops.eri import _r2_gather, _r2m_plan
from qchem_rs_tpu_torch.ops.mcmurchie import _r_plan, hermite_components, nhermite, r_table_components
from qchem_rs_tpu_torch.utils.cuda import CudaKernel, stream_of

#: highest total angular momentum Lb + Lk the CUDA kernel handles (its R
#: table is a fixed 165-entry local array)
KERNEL_MAX_L = 8

_c = ctypes
KERNEL = CudaKernel(
    "eri_tile.cu",
    "eri_bra_tiles",
    [_c.c_int] * 10 + [_c.c_void_p] * 11,
)


def _tile_index(t: np.ndarray, T: int, device) -> torch.Tensor:
    """(ntiles, T) pair indices of the tiles starting at offsets ``t``."""
    return torch.as_tensor(t[:, None] + np.arange(T)[None, :], dtype=torch.long, device=device)


def bra_tiles_plain(Lb, Lk, E1, p1, P1, p2, P2, ti, tj, T1, T2):
    """The twin, the bra half of the JAX package's ``_tile_vals`` with a
    tile batch axis: R tables by the vectorized recursion, the fused R2m
    gather of ``_r2m_plan`` and one einsum for the bra contraction. Same
    arguments and result as ``bra_tiles``."""
    dev = E1.device
    nt = len(ti)
    N1, a, A, S1 = E1.shape
    c = p2.shape[1]
    i1 = _tile_index(ti, T1, dev)
    i2 = _tile_index(tj, T2, dev)
    p1t = p1[i1].permute(2, 0, 1)[:, None, :, :, None]  # (a, 1, nt, T1, 1)
    p2t = p2[i2].permute(2, 0, 1)[None, :, :, None, :]  # (1, c, nt, 1, T2)
    ps = p1t + p2t  # (a, c, nt, T1, T2)
    pq = p1t * p2t
    alpha = pq / ps
    P1t = P1[i1].permute(3, 2, 0, 1)  # (3, a, nt, T1)
    P2t = P2[i2].permute(3, 2, 0, 1)  # (3, c, nt, T2)
    PQ = [P1t[d][:, None, :, :, None] - P2t[d][None, :, :, None, :] for d in range(3)]
    R = r_table_components(Lb + Lk, alpha, *PQ)  # (H, a, c, nt, T1, T2)
    R = R * (2.0 * math.pi**2.5 / (pq * torch.sqrt(ps)))[None]
    h_arr, ac_arr, sign_m = _r2m_plan(Lb, Lk, a, c)
    Rf = R.reshape(R.shape[0], a * c, nt, T1, T2)
    R2m = Rf[torch.tensor(h_arr, device=dev), torch.tensor(ac_arr, device=dev)]
    R2m = R2m * torch.as_tensor(sign_m, dtype=R.dtype, device=dev)[None, :, None, None, None]
    E1m = E1[i1].permute(2, 4, 3, 0, 1).reshape(a * S1, A, nt, T1)  # ((a, s1), A, nt, T1)
    # contract (a, s1): -> (nt, A, (c, s2), T1, T2)
    return torch.einsum("kAnx,kmnxy->nAmxy", E1m, R2m)


@lru_cache(maxsize=None)
def _plans(Lb: int, Lk: int, device: str) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's int32 plan buffers on ``device``: rplan (5, H) = (PC
    dimension, idx1, idx2, coefficient, order) per Hermite entry, and
    r2plan = idx (S1*S2) followed by sign (S2) of the (s1, s2) gather."""
    L = Lb + Lk
    onehot, idx1, idx2, coef = _r_plan(L)
    order = np.array([sum(s) for s in hermite_components(L)])
    rplan = np.stack([onehot.argmax(axis=1), idx1, idx2, coef, order]).astype(np.int32)
    idx, sign = _r2_gather(Lb, Lk)
    r2plan = np.concatenate([idx.reshape(-1), sign]).astype(np.int32)
    return (
        torch.as_tensor(np.ascontiguousarray(rplan), device=device),
        torch.as_tensor(r2plan, device=device),
    )


def _check(Lb, Lk, E1, p1, P1, p2, P2, ti, tj, T1, T2) -> None:
    dev = E1.device
    for name, t in (("E1", E1), ("p1", p1), ("P1", P1), ("p2", p2), ("P2", P2)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, E1 on {dev}")
        if t.dtype != torch.float64:
            raise TypeError(f"{name} must be float64, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    N1, a, A, S1 = E1.shape
    N2, c = p2.shape
    if S1 != nhermite(Lb) or p1.shape != (N1, a) or P1.shape != (N1, a, 3):
        raise ValueError(
            f"bra shapes E1 {tuple(E1.shape)}, p1 {tuple(p1.shape)}, "
            f"P1 {tuple(P1.shape)} do not fit Lb={Lb}"
        )
    if P2.shape != (N2, c, 3):
        raise ValueError(f"ket shapes p2 {tuple(p2.shape)}, P2 {tuple(P2.shape)}")
    ti, tj = np.asarray(ti), np.asarray(tj)
    if ti.shape != tj.shape or ti.ndim != 1:
        raise ValueError("ti and tj must be 1-d and of equal length")
    if len(ti) and (ti.min() < 0 or tj.min() < 0 or ti.max() + T1 > N1 or tj.max() + T2 > N2):
        raise ValueError("a tile reaches outside its class")


def bra_tiles(Lb, Lk, E1, p1, P1, p2, P2, ti, tj, T1, T2) -> torch.Tensor:
    """Bra-contracted ERI tiles, (ntiles, A, c*S2, T1, T2) float64.

    E1 (N1, a, A, S1), p1 (N1, a), P1 (N1, a, 3) hold the whole bra class and
    p2 (N2, c), P2 (N2, c, 3) the ket class, in the layouts of the JAX
    package's ``_tile_vals``; ``ti``/``tj`` are host integer arrays of tile
    offsets. CPU tensors take the twin; CUDA tensors launch the kernel.
    """
    _check(Lb, Lk, E1, p1, P1, p2, P2, ti, tj, T1, T2)
    dev = E1.device
    if dev.type == "cpu":
        return bra_tiles_plain(Lb, Lk, E1, p1, P1, p2, P2, ti, tj, T1, T2)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if Lb + Lk > KERNEL_MAX_L:
        raise NotImplementedError(
            f"the CUDA tile kernel covers Lb + Lk <= {KERNEL_MAX_L}, got {Lb + Lk}"
        )
    N1, a, A, S1 = E1.shape
    c = p2.shape[1]
    S2 = nhermite(Lk)
    nt = len(ti)
    out = torch.empty((nt, A, c * S2, T1, T2), dtype=torch.float64, device=dev)
    if nt == 0:
        return out
    rplan, r2plan = _plans(Lb, Lk, str(dev))
    ti_d = torch.as_tensor(np.asarray(ti, dtype=np.int32), device=dev)
    tj_d = torch.as_tensor(np.asarray(tj, dtype=np.int32), device=dev)
    with torch.cuda.device(dev):
        KERNEL.launch(
            Lb, Lk, a, c, A, S1, S2, T1, T2, nt,
            E1.data_ptr(), p1.data_ptr(), P1.data_ptr(), p2.data_ptr(), P2.data_ptr(),
            ti_d.data_ptr(), tj_d.data_ptr(), rplan.data_ptr(), r2plan.data_ptr(),
            out.data_ptr(), stream_of(out),
        )
    return out
