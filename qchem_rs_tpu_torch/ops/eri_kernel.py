"""Kernel 1, the bra-contracted ERI tile (``csrc/eri_tile.cu``), and kernel
3, the finished tile values of the direct pass (``csrc/eri_tile_values.cu``),
beside their plain PyTorch twins.

For one class pair (bra pairs of total angular momentum Lb, ket pairs of
Lk) and a batch of pair tiles (row offsets ``ti`` into the bra class, column
offsets ``tj`` into the ket class), both compute

    out[tile, alpha, ic*S2 + s2, t1, t2]
        = sum_{ia, s1} E1[ti+t1, ia, alpha, s1] * sign[s2] * pref
                       * R[idx[s1, s2]](ia, ic, t1, t2)

where R is the Hermite Coulomb table of the primitive quartet (bra primitive
pair ia of pair ti+t1, ket primitive pair ic of pair tj+t2), pref =
2 pi^{5/2} / (pq sqrt(p+q)) and idx/sign the (s1, s2) plan of
``eri._r2_gather``. The ket contraction with E2 follows outside, a batched
matmul (``ket_contract``), or in kernel 3 below.

Replaces the three TPU kernels of ``qchem_rs_tpu/ops/eri_pallas.py``:
``_kernel_fused_e1`` (:205), ``_kernel_fused`` (:175) and ``_kernel_htab``
(:191). Those split the chain differently per class only because of VMEM
size and Mosaic's unroll limits; on the H100 one f64 kernel template,
instantiated for each (Lb, Lk) with Lb, Lk <= 4, serves every class pair of
bases up to d shells such as cc-pVDZ. The pair classes with Lb or Lk of 5
or 6 (f-shell pairs, up to (ff|ff) at L = 12, where the JAX package falls
back to XLA f64 past L = 8) take the high-L part, ``csrc/eri_tile_highl.cu``:
one kernel with L given at run time and its plan in a small device table
(``highl_plan``), in which a thread block builds one R table per primitive
quartet in shared memory, level by level across its threads, and shares it
among every output of its ket point (the launch shape: ``highl_schedule``).
Both parts have the same contract and output layout, and each counts its
own launches.

With primitive counts (``PrimCounts``: each pair's primitive pairs with
nonzero E first, and their number), the kernel sums only over real bra
primitive pairs and writes 0.0 for ket primitive pairs past a pair's count
(their E2 is zero); the twin gives the same result by masking those ket
entries, since zero-E bra primitive pairs add exactly zero to its sums.

What bounds the template part on the H100: the write of its output, once
only real primitive quartets are computed. The design (notes in the
source): the kernel is a template on (Lb, Lk), so the R recursion and the (s1, s2)
gather unroll into constant indices and R stays on chip (registers, or the
thread's column of shared memory for L >= 5); one thread owns one (tile,
alpha chunk, t1, ket point) and keeps its sums in registers over the whole
bra loop, storing them once; Boys runs without a division in any loop
(``boys_on_card`` runs it alone, to hold against ``boys.boys``).

On CPU tensors ``bra_tiles`` runs the twin; on CUDA tensors it launches one
of the two parts or raises.

Kernel 3 (``tile_values``) computes the whole chain for every class pair
of the direct pass: both contractions, so that its (ntiles, T1*A, T2*C)
result is ``ket_contract(bra_tiles(...))``, which is its twin
(``tile_values_plain``). It replaces ``tile_vals_pallas``
(``qchem_rs_tpu/ops/eri_pallas.py:430``, the Pallas bodies ``_kernel_fused``
:175 and ``_kernel_htab`` :191 with the contractions in XLA, and the XLA
f64 path past L = 8) on the direct pass. Each real primitive quartet's R
is built once and both contractions add into sums on chip; only the
finished blocks are written. Like kernel 1 it has two parts. The template
part, ``csrc/eri_tile_values.cu``, takes Lb, Lk <= 4; a block owns one bra
pair of a tile: in the row kernel (class pairs whose alphas all fit one
thread) its threads take the tile's real ket points, as kernel 1's do; in
the shared kernel its threads build a round of R tables in shared memory
for the owners of each ket pair's sums. Class pairs with d-d ket pairs are
computed from their ket side and written transposed (``swap_sides``; notes
in the source). The high-L part, ``csrc/eri_tile_values_highl.cu``, takes
the f-shell class pairs (Lb or Lk of 5 or 6) with L at run time: a block
owns a bra pair, a group of its tile's ket pairs and a chunk of its alphas
(the launch shape: ``values_highl_schedule``), builds R tables level by
level in shared memory as kernel 1's high-L part does, and adds each ket
pair's values over its ket points in registers; it reads the ket class's E
with its components last (``ket_layout``).
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from functools import lru_cache

import numpy as np
import torch

from qchem_rs_tpu_torch.ops.eri import _r2_gather, _r2m_plan
from qchem_rs_tpu_torch.ops.mcmurchie import _r_plan, hermite_components, nhermite, r_table_components
from qchem_rs_tpu_torch.utils.cuda import CudaKernel, stream_of

#: highest angular momentum Lb (bra pair) or Lk (ket pair) of the template
#: part, csrc/eri_tile.cu: one instantiation per (Lb, Lk), every pair class
#: up to (d, d)
KERNEL_MAX_SIDE = 4
#: highest Lb or Lk of the high-L part, csrc/eri_tile_highl.cu, which takes
#: every class pair with Lb or Lk above KERNEL_MAX_SIDE: up to (f, f)
HIGHL_MAX_SIDE = 6
#: highest order of the kernels' Boys function
KERNEL_MAX_L = 2 * HIGHL_MAX_SIDE

#: translation units of csrc/eri_tile.cu, one per (Lb, Lk), built by
#: concurrent nvcc processes
BUILD_PARTS = (KERNEL_MAX_SIDE + 1) ** 2

_c = ctypes
KERNEL = CudaKernel(
    "eri_tile.cu",
    "eri_bra_tiles",
    [_c.c_int] * 8 + [_c.c_void_p] * 12,
    parts=BUILD_PARTS,
)
#: the high-L part: pair classes with Lb or Lk of 5 or 6, L given at run time
HIGHL_KERNEL = CudaKernel(
    "eri_tile_highl.cu",
    "eri_bra_tiles_highl",
    [_c.c_int] * 15 + [_c.c_void_p] * 14,
)
#: kernel 3: finished tile values, classes with Lb, Lk <= 4, one translation
#: unit per (Lb, Lk) as kernel 1's template part
VALUES_KERNEL = CudaKernel(
    "eri_tile_values.cu",
    "eri_tile_values",
    [_c.c_int] * 11 + [_c.c_void_p] * 15,
    parts=BUILD_PARTS,
)
#: kernel 3's high-L part: class pairs with Lb or Lk of 5 or 6, L given at
#: run time
VALUES_HIGHL_KERNEL = CudaKernel(
    "eri_tile_values_highl.cu",
    "eri_tile_values_highl",
    [_c.c_int] * 17 + [_c.c_void_p] * 13,
)
#: the kernels' Boys function on its own, for holding it against ``boys``
BOYS_PROBE = CudaKernel(
    "eri_tile.cu",
    "eri_boys",
    [_c.c_int, _c.c_int, _c.c_void_p, _c.c_void_p, _c.c_void_p],
    parts=BUILD_PARTS,
)


@dataclasses.dataclass(frozen=True)
class PrimCounts:
    """Real primitive pairs of one padded class whose pairs list them first.

    n (N,) int32: primitive pairs with nonzero E per pair. order (N/T, c*T)
    int32: per block of T pairs (a tile), its ket points ``ic*T + t`` with
    ic < n[pair] first, in ascending order, then the others; nreal (N/T,)
    int32: how many of them are real; pos (N/T, c*T) int32: the place of
    ket point ``ic*T + t`` in its block's ``order``."""

    n: torch.Tensor
    order: torch.Tensor
    nreal: torch.Tensor
    pos: torch.Tensor
    T: int


def _nonzero_prims(E: torch.Tensor) -> torch.Tensor:
    """(N, a) bool: primitive pairs whose E has a nonzero entry."""
    return E.reshape(E.shape[0], E.shape[1], -1).ne(0).any(dim=-1)


def compact_order(E: torch.Tensor) -> torch.Tensor:
    """(N, a) per-pair order of a padded class's primitive pairs that puts
    those with nonzero E first (stable, so real primitive pairs keep their
    order)."""
    nz = _nonzero_prims(E)
    return torch.argsort((~nz).to(torch.int8), dim=1, stable=True)


def compact_prims(E: torch.Tensor, p: torch.Tensor, P: torch.Tensor, perm=None):
    """(E, p, P) of a padded class with each pair's primitive pairs
    reordered by ``perm``, ``compact_order(E)`` when None."""
    if perm is None:
        perm = compact_order(E)
    E = torch.take_along_dim(E, perm[:, :, None, None], dim=1)
    p = torch.take_along_dim(p, perm, dim=1)
    P = torch.take_along_dim(P, perm[:, :, None], dim=1)
    return E.contiguous(), p.contiguous(), P.contiguous()


def prim_counts(E: torch.Tensor, T: int) -> PrimCounts:
    """The kernel's counts for a class compacted by ``compact_prims`` and
    padded to a multiple of its tile edge T."""
    N, c = E.shape[:2]
    if N % T:
        raise ValueError(f"{N} pairs are not a multiple of the tile edge {T}")
    nz = _nonzero_prims(E)
    n = nz.sum(dim=1)
    if not torch.equal(nz, torch.arange(c, device=E.device)[None, :] < n[:, None]):
        raise ValueError("primitive pairs with nonzero E must come first (compact_prims)")
    real = nz.reshape(N // T, T, c).transpose(1, 2).reshape(N // T, c * T)  # [block, ic*T + t]
    key = (~real).to(torch.int64) * (c * T) + torch.arange(c * T, device=E.device)
    order = torch.argsort(key, dim=1)
    return PrimCounts(
        n=n.to(torch.int32).contiguous(),
        order=order.to(torch.int32).contiguous(),
        nreal=real.sum(dim=1).to(torch.int32).contiguous(),
        pos=torch.argsort(order, dim=1).to(torch.int32).contiguous(),
        T=T,
    )


def all_prims(N: int, c: int, T: int, device) -> PrimCounts:
    """Counts that take every primitive pair of a class of N pairs as real,
    in their own order: what the kernel computes when no counts are given."""
    i32 = dict(dtype=torch.int32, device=device)
    order = torch.arange(c * T, **i32).expand(N // T, c * T).contiguous()
    return PrimCounts(n=torch.full((N,), c, **i32), order=order,
                      nreal=torch.full((N // T,), c * T, **i32), pos=order, T=T)


@lru_cache(maxsize=None)
def highl_plan(Lb: int, Lk: int) -> np.ndarray:
    """The high-L part's device table for class pair (Lb, Lk), int32, with R
    stored in level order (the H Hermite entries of L = Lb + Lk sorted
    stably by their order t+u+v, so that the entries a recursion level
    needs come first):

    - L+1 level sizes: level n computes the first nherm(L - n) entries;
    - H packed recursion steps in level order (``mcmurchie._r_plan``): bits
      0-1 the dimension d, 2-5 the coefficient, 6-14 the level-order
      position of s - e_d, 15-23 that of s - 2 e_d;
    - the (S1, S2) gather of ``eri._r2_gather`` as level-order positions;
    - one flag per s2 whose sign is -1."""
    L = Lb + Lk
    onehot, idx1, idx2, coef = _r_plan(L)
    order = np.asarray(hermite_components(L)).sum(axis=1)
    sorted_s = np.argsort(order, kind="stable")  # position -> entry
    pos = np.argsort(sorted_s)  # entry -> position
    steps = (onehot.argmax(axis=1) | coef.astype(np.int64) << 2
             | pos[idx1].astype(np.int64) << 6 | pos[idx2].astype(np.int64) << 15)[sorted_s]
    levels = [nhermite(L - n) for n in range(L + 1)]
    idx, sign = _r2_gather(Lb, Lk)
    return np.concatenate([levels, steps, pos[idx].ravel(), (sign < 0)]).astype(np.int32)


#: threads of a high-L block at most (the kernel's __launch_bounds__)
HIGHL_MAX_THREADS = 256
#: shared-memory budgets of a high-L block in bytes: its R tables, its staged
#: E1 rows and its sums (a block takes more only when one item or column
#: needs it)
HIGHL_BUDGETS = (64 << 10, 16 << 10, 16 << 10)


@dataclasses.dataclass(frozen=True)
class HighlSchedule:
    """The high-L part's launch shape for one class pair and tile batch.

    A block owns one (tile, t1), a group of W consecutive ket points of its
    tile block in ``korder`` (real ones first; ceil(c*T2 / W) groups per t1)
    and split ``split`` of the bra primitives, [split*ps, (split+1)*ps). It
    holds R tables for NI (ket point, bra primitive) items and E1 rows of KB
    bra primitives at once; with r real ket points in its group it walks its
    bra primitives in batches of max(1, min(KB, NI // r)). Its NT threads
    own its sums in slices of (real ket point, s2, 4 alphas), ket points
    fastest, round robin: thread t the slices t, t + NT, .... With nsplit > 1
    every split writes its partial sums and a second kernel adds them in
    split order.
    """

    W: int
    NI: int
    KB: int
    NT: int
    nsplit: int
    ps: int


def highl_smem_parts(Lb: int, Lk: int, A: int) -> tuple[int, int, int, int]:
    """Bytes of a high-L block's shared memory, in the layout of ``carve``
    in ``csrc/eri_tile_highl.cu``: (per staged bra primitive, per R item,
    per column, fixed). A primitive holds its E1 rows, alphas padded to
    slices of 4; an item its two R level buffers, its Boys base and PC; a
    column its sums and two ints; the fixed part the plan's level sizes,
    steps and sign flags (ints) and its gather (shorts)."""
    L = Lb + Lk
    H, S1, S2 = nhermite(L), nhermite(Lb), nhermite(Lk)
    return (8 * S1 * (-(-A // 4) * 4), 8 * (H + nhermite(L - 1) + L + 1 + 3), 8 * A * S2 + 8,
            4 * (L + 1 + H + S2) + 2 * S1 * S2)


def highl_smem_bytes(Lb: int, Lk: int, A: int, sc: HighlSchedule) -> int:
    """Dynamic shared memory of one high-L block under ``sc``, rounded up to
    16 bytes. The launcher counts it again from the same layout and refuses
    a launch whose count differs."""
    e1, item, col, fixed = highl_smem_parts(Lb, Lk, A)
    return -(-(sc.KB * e1 + sc.NI * item + sc.W * col + fixed) // 16) * 16


@lru_cache(maxsize=None)
def highl_schedule(Lb: int, Lk: int, a: int, c: int, A: int, T1: int, T2: int, ntiles: int,
                   sms: int, budgets: tuple = HIGHL_BUDGETS,
                   max_threads: int = HIGHL_MAX_THREADS) -> HighlSchedule:
    """The launch shape of the high-L part for class pair (Lb, Lk) with a
    bra and c ket primitive pairs, A bra components, tile edges T1, T2 and
    ``ntiles`` tiles, on a card of ``sms`` streaming multiprocessors: a
    class pair with fewer than two blocks per SM splits its bra loop.
    ``budgets`` and ``max_threads`` as ``HIGHL_BUDGETS`` and
    ``HIGHL_MAX_THREADS``."""
    e1, item, col, _ = highl_smem_parts(Lb, Lk, A)
    r_budget, e1_budget, acc_budget = budgets
    NI = max(1, r_budget // item)
    KP = c * T2
    W = max(1, min(KP, 32, NI, acc_budget // col))
    KB = max(1, min(a, NI, e1_budget // e1))
    NI = min(NI, W * KB)
    slices = W * nhermite(Lk) * -(-A // 4)  # of 4 alphas
    NT = min(max_threads, max(64, -(-slices // 32) * 32))
    blocks = ntiles * T1 * -(-KP // W)
    nsplit = 1 if blocks >= 2 * sms else min(a, -(-2 * sms // blocks))
    ps = -(-a // nsplit)
    nsplit = -(-a // ps)
    return HighlSchedule(W=W, NI=NI, KB=KB, NT=NT, nsplit=nsplit, ps=ps)


@lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@lru_cache(maxsize=None)
def _device_plan(Lb: int, Lk: int, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(highl_plan(Lb, Lk), device=device)


#: threads of a block of kernel 3's high-L part at most (its __launch_bounds__)
VALUES_HIGHL_MAX_THREADS = 256
#: shared-memory budgets of a block of kernel 3's high-L part in bytes: its R
#: tables, its staged E1 rows, its chunk's bra sums and its values (a block
#: takes more only when one item, primitive or ket point needs it)
VALUES_HIGHL_BUDGETS = (32 << 10, 16 << 10, 32 << 10, 24 << 10)
#: ket pairs of one block at most (a ket point mask of the kernel is 32 bits)
VALUES_HIGHL_MAX_GROUP = 32


@dataclasses.dataclass(frozen=True)
class ValuesHighlSchedule:
    """The launch shape of kernel 3's high-L part for one class pair (seen
    from the side it is computed from) and tile batch.

    A block owns one bra pair (tile, t1), a group of G ket pairs of the
    tile and a chunk of Ah alphas (ceil(T2 / G) * ceil(A / Ah) blocks per
    bra pair), and every real ket point of its ket pairs, which it walks in
    chunks of W. It holds R tables for NI (ket point, bra primitive) items
    and E1 rows of KB bra primitives at once; with r ket points in its
    chunk it walks its bra primitives in batches of max(1, min(KB, NI //
    r)). NT threads."""

    Ah: int
    G: int
    W: int
    NI: int
    KB: int
    NT: int


def values_highl_smem_bytes(Lb: int, Lk: int, c: int, C: int, sc: ValuesHighlSchedule) -> int:
    """Dynamic shared memory of one block of kernel 3's high-L part under
    ``sc``, in the layout of ``carve`` in ``csrc/eri_tile_values_highl.cu``,
    rounded up to 16 bytes: doubles (staged E1 rows and the chunk's bra
    sums, alphas padded to slices of 4; per item two R level buffers, Boys
    base and PC; the block's values), then ints (plan levels, steps
    and sign flags; the group's counts and list heads; per ket primitive a
    mask and an offset; per chunk entry its pair, primitive and successor),
    then the plan's gather as shorts. The launcher counts it again from the
    same layout and refuses a launch whose count differs."""
    L = Lb + Lk
    H, H1, S1, S2 = nhermite(L), nhermite(L - 1), nhermite(Lb), nhermite(Lk)
    A4 = -(-sc.Ah // 4) * 4
    doubles = sc.KB * S1 * A4 + A4 * S2 * sc.W + (H + H1 + L + 1 + 3) * sc.NI + sc.Ah * sc.G * C
    ints = L + 1 + H + S2 + 2 * sc.G + 2 * (c + 1) + 3 * sc.W
    return -(-(8 * doubles + 4 * ints + 2 * S1 * S2) // 16) * 16


@lru_cache(maxsize=None)
def values_highl_schedule(Lb: int, Lk: int, a: int, c: int, A: int, C: int, T1: int, T2: int,
                          ntiles: int, sms: int) -> ValuesHighlSchedule:
    """The launch shape of kernel 3's high-L part for class pair (Lb, Lk),
    seen from the side it is computed from, with a bra and c ket primitive
    pairs, A bra and C ket components, tile edges T1, T2 and ``ntiles``
    tiles, on a card of ``sms`` streaming multiprocessors: the values of G
    ket pairs and Ah alphas fit their budget (all of a tile's ket pairs if
    they can, else fewer, else fewer alphas), and a class pair with fewer
    than two blocks per SM takes smaller alpha chunks (each chunk builds its
    R tables again, a small share where A is large); within
    ``VALUES_HIGHL_BUDGETS`` and ``VALUES_HIGHL_MAX_THREADS``."""
    r_budget, e1_budget, acc_budget, out_budget = (b // 8 for b in VALUES_HIGHL_BUDGETS)  # doubles
    L = Lb + Lk
    S1, S2 = nhermite(Lb), nhermite(Lk)
    G = max(1, min(T2, VALUES_HIGHL_MAX_GROUP, out_budget // (A * C)))
    Ah = min(A, max(1, out_budget // (G * C)))
    if Ah < A and Ah >= 4:
        Ah -= Ah % 4
    while ntiles * T1 * -(-T2 // G) * -(-A // Ah) < 2 * sms and Ah > 4:
        Ah = -(-Ah // 8) * 4  # half, in slices of 4
    NI = max(1, r_budget // (nhermite(L) + nhermite(L - 1) + L + 1 + 3))
    W = max(1, min(G * c, 32, NI, acc_budget // (-(-Ah // 4) * 4 * S2)))
    KB = max(1, min(a, NI, e1_budget // (S1 * -(-Ah // 4) * 4)))
    NI = max(W, min(NI, W * KB))
    work = max(W * S2 * -(-Ah // 4), Ah * G * C)  # bra slices, values
    NT = min(VALUES_HIGHL_MAX_THREADS, max(64, -(-work // 32) * 32))
    return ValuesHighlSchedule(Ah=Ah, G=G, W=W, NI=NI, KB=KB, NT=NT)


def _tile_index(t: np.ndarray, T: int, device) -> torch.Tensor:
    """(ntiles, T) pair indices of the tiles starting at offsets ``t``."""
    return torch.as_tensor(t[:, None] + np.arange(T)[None, :], dtype=torch.long, device=device)


def bra_tiles_plain(Lb, Lk, E1, p1, P1, p2, P2, ti, tj, T1, T2, bra=None, ket=None,
                    offsets=None):
    """The twin, the bra half of the JAX package's ``_tile_vals`` with a
    tile batch axis: R tables by the vectorized recursion, the fused R2m
    gather of ``_r2m_plan`` and one einsum for the bra contraction. Same
    arguments and result as ``bra_tiles``: with ``ket`` counts, entries of
    ket primitive pairs past a pair's count are 0.0 (``bra`` counts change
    nothing here, since the bra sum over zero-E primitive pairs is exact;
    nor do ``offsets``, which repeat ti and tj)."""
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
    out = torch.einsum("kAnx,kmnxy->nAmxy", E1m, R2m)
    if ket is None:
        return out
    real = torch.arange(c, device=dev)[None, :, None] < ket.n[i2].to(torch.long)[:, None, :]
    S2 = nhermite(Lk)
    out = out.reshape(nt, A, c, S2, T1, T2) * real[:, None, :, None, None, :]
    return out.reshape(nt, A, c * S2, T1, T2)


def _check(Lb, Lk, E1, p1, P1, p2, P2, ti, tj, T1, T2, bra, ket) -> None:
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
    if (bra is None) != (ket is None):
        raise ValueError("give primitive counts for both classes or for neither")
    if ket is not None:
        if bra.n.shape != (N1,) or ket.n.shape != (N2,) or ket.order.shape != (N2 // T2, c * T2):
            raise ValueError("primitive counts do not fit the classes")
        if ket.T != T2 or (len(tj) and (tj % T2).any()):
            raise ValueError(f"with counts, ket tiles must start at multiples of T2={T2}")
        for t in (bra.n, ket.n, ket.order, ket.nreal):
            if t.device != dev or t.dtype != torch.int32:
                raise ValueError(f"primitive counts must be int32 on {dev}")


def bra_tiles(Lb, Lk, E1, p1, P1, p2, P2, ti, tj, T1, T2, bra=None, ket=None,
              offsets=None, schedule=None) -> torch.Tensor:
    """Bra-contracted ERI tiles, (ntiles, A, c*S2, T1, T2) float64.

    E1 (N1, a, A, S1), p1 (N1, a), P1 (N1, a, 3) hold the whole bra class and
    p2 (N2, c), P2 (N2, c, 3) the ket class, in the layouts of the JAX
    package's ``_tile_vals``; ``ti``/``tj`` are host integer arrays of tile
    offsets. ``bra``/``ket`` are the classes' ``PrimCounts`` (both or
    neither; without them every primitive pair counts as real, and the
    kernel gets ``all_prims`` counts). ``offsets`` may hold ti and tj
    already on the device as int32 tensors, for a caller that launches the
    same tiles again and again; without them both go to the card in one
    copy that does not wait for the card's queue (a blocking copy would).
    CPU tensors take the twin; CUDA tensors launch the
    kernel: the template part for Lb, Lk <= 4, the high-L part for the
    classes with Lb or Lk of 5 or 6, in the launch shape ``schedule``
    (``highl_schedule``'s when None; another, to try it, only for the
    high-L part).
    """
    _check(Lb, Lk, E1, p1, P1, p2, P2, ti, tj, T1, T2, bra, ket)
    dev = E1.device
    if dev.type == "cpu":
        return bra_tiles_plain(Lb, Lk, E1, p1, P1, p2, P2, ti, tj, T1, T2, bra, ket)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if max(Lb, Lk) > HIGHL_MAX_SIDE:
        raise ValueError(f"the CUDA tile kernels take Lb, Lk <= {HIGHL_MAX_SIDE}, got ({Lb}, {Lk})")
    if schedule is not None and max(Lb, Lk) <= KERNEL_MAX_SIDE:
        raise ValueError(f"a schedule is for the high-L part only, not ({Lb}, {Lk})")
    N1, a, A, S1 = E1.shape
    c = p2.shape[1]
    S2 = nhermite(Lk)
    nt = len(ti)
    out = torch.empty((nt, A, c * S2, T1, T2), dtype=torch.float64, device=dev)
    if nt == 0:
        return out
    ti_d, tj_d = _offsets(ti, tj, offsets, dev)
    if ket is None:
        bra, ket = all_prims(N1, a, T1, dev), all_prims(p2.shape[0], c, T2, dev)
    ptrs = (E1.data_ptr(), p1.data_ptr(), P1.data_ptr(), p2.data_ptr(), P2.data_ptr(),
            ti_d.data_ptr(), tj_d.data_ptr(), bra.n.data_ptr())
    with torch.cuda.device(dev):
        if max(Lb, Lk) <= KERNEL_MAX_SIDE:
            KERNEL.launch(Lb, Lk, a, c, A, T1, T2, nt, *ptrs, ket.order.data_ptr(),
                          ket.nreal.data_ptr(), out.data_ptr(), stream_of(out))
        else:
            sc = schedule or highl_schedule(Lb, Lk, a, c, A, T1, T2, nt, _sm_count(dev))
            partials = (torch.empty((sc.nsplit,) + out.shape, dtype=out.dtype, device=dev)
                        if sc.nsplit > 1 else out)
            HIGHL_KERNEL.launch(Lb, Lk, a, c, A, T1, T2, nt, sc.W, sc.NI, sc.KB, sc.NT,
                                sc.nsplit, sc.ps, highl_smem_bytes(Lb, Lk, A, sc), *ptrs,
                                ket.order.data_ptr(), ket.nreal.data_ptr(),
                                _device_plan(Lb, Lk, dev).data_ptr(),
                                partials.data_ptr(), out.data_ptr(), stream_of(out))
    return out


def ket_contract(bra: torch.Tensor, E2: torch.Tensor, tj, T2: int) -> torch.Tensor:
    """Ket Hermite->Cartesian contraction of bra-contracted tiles.

    bra (nt, A, c*S2, T1, T2) from ``bra_tiles``; E2 (N2, c, C, S2) the ket
    class; tj the ket tile offsets, on the host or as a tensor on bra's
    device. Returns the (nt, T1*A, T2*C) V2 blocks, rows (t1, alpha) and
    columns (t2, gamma)."""
    nt, A, cS2, T1, _ = bra.shape
    C = E2.shape[2]
    tj = torch.as_tensor(tj, dtype=torch.long, device=bra.device)
    i2 = tj[:, None] + torch.arange(T2, device=bra.device)
    E2t = E2[i2].permute(0, 1, 2, 4, 3).reshape(nt * T2, cS2, C)  # (nt*T2, (c,s2), C)
    x = bra.permute(0, 4, 3, 1, 2).reshape(nt * T2, T1 * A, cS2)  # (nt*T2, (t1,alpha), (c,s2))
    out = torch.bmm(x, E2t).reshape(nt, T2, T1 * A, C)
    return out.permute(0, 2, 1, 3).reshape(nt, T1 * A, T2 * C)


def tile_values_plain(Lb, Lk, E1, p1, P1, E2, p2, P2, ti, tj, T1, T2, bra=None, ket=None,
                      offsets=None):
    """Kernel 3's twin: ``bra_tiles_plain`` followed by ``ket_contract``,
    (ntiles, T1*A, T2*C) float64 (``offsets`` change nothing here)."""
    return ket_contract(bra_tiles_plain(Lb, Lk, E1, p1, P1, p2, P2, ti, tj, T1, T2, bra, ket),
                        E2, tj, T2)


def swap_sides(Lb: int, Lk: int) -> bool:
    """Whether kernel 3 computes class pair (Lb, Lk) from the ket side: the
    (Lk, Lb) blocks, written transposed, for ket pairs of Lk = 4 (d-d
    pairs: 36 Cartesian components) under a lighter bra. From the bra side
    each thread's ket contraction loads its own ket pair's whole E2 row
    (1260 doubles for a d-d pair) for one multiply-add a load; from the ket
    side that row is the block's E1, loaded once for all its threads.
    ``tools/values_trials.py`` times both sides of every naphthalene/cc-pVDZ
    class pair: the ket side wins for the d-d ket pairs and loses for the
    ket classes of Lk = 3. The high-L part computes every class pair from
    its bra side: ``tools/values_trials.py --highl`` times both sides of
    every f-shell class pair of ferrocene/6-31G*, whose f-shell classes
    come last and so are the ket side of nearly all of them."""
    return Lk == KERNEL_MAX_SIDE and Lb < Lk


def _offsets(ti, tj, offsets, dev) -> tuple:
    """The tile offsets as two int32 tensors on ``dev``: ``offsets`` when
    given (checked), else ti and tj copied in one copy that does not wait
    for the card's queue."""
    nt = len(ti)
    if offsets is None:
        offsets = tuple(torch.from_numpy(np.stack([ti, tj]).astype(np.int32)).to(dev, non_blocking=True))
    if any(t.device != dev or t.dtype != torch.int32 or t.shape != (nt,) for t in offsets):
        raise ValueError(f"offsets must be two int32 tensors of shape ({nt},) on {dev}")
    return offsets


def ket_layout(E: torch.Tensor, highl: bool) -> torch.Tensor:
    """A class's E (N, c, X, S) in the layout kernel 3 reads on its ket
    side: pair axis last, (c, X, S, N), for the template part, so that
    threads on consecutive ket pairs read together; components last, (N,
    c, S, X), for the high-L part, so that threads on consecutive ket
    components read together."""
    return (E.transpose(2, 3) if highl else E.permute(1, 2, 3, 0)).contiguous()


def tile_values(Lb, Lk, E1, p1, P1, E2, p2, P2, ti, tj, T1, T2, bra=None, ket=None,
                offsets=None, E1t=None, E2t=None, trans=None) -> torch.Tensor:
    """Finished ERI tile values, (ntiles, T1*A, T2*C) float64: rows (t1,
    alpha), columns (t2, gamma), as ``ket_contract`` of ``bra_tiles``.

    Arguments as ``bra_tiles``, with E2 (N2, c, C, S2) the ket class's
    Hermite table; ``E1t`` and ``E2t`` may hold ``ket_layout`` of E1 and E2
    for the part that the class pair takes, for a caller that launches the
    same classes again and again (the kernel reads the one of its ket side,
    ``swap_sides``; without it the copy is made here). CPU tensors take the
    twin; CUDA tensors launch kernel 3: its template part for class pairs
    with Lb, Lk <= 4, its high-L part for those with Lb or Lk of 5 or 6, in
    the launch shape of ``values_highl_schedule`` and from the side
    ``trans`` (``swap_sides`` when None; another side, to check or time
    it, only for the high-L part)."""
    _check(Lb, Lk, E1, p1, P1, p2, P2, ti, tj, T1, T2, bra, ket)
    N2, c = p2.shape
    if E2.device != E1.device or E2.dtype != torch.float64 or not E2.is_contiguous():
        raise ValueError("E2 must be a contiguous float64 tensor on E1's device")
    if E2.dim() != 4 or E2.shape[:2] != (N2, c) or E2.shape[3] != nhermite(Lk):
        raise ValueError(f"ket shape E2 {tuple(E2.shape)} does not fit p2 {tuple(p2.shape)}, Lk={Lk}")
    dev = E1.device
    if dev.type == "cpu":
        return tile_values_plain(Lb, Lk, E1, p1, P1, E2, p2, P2, ti, tj, T1, T2, bra, ket)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if max(Lb, Lk) > HIGHL_MAX_SIDE:
        raise ValueError(f"kernel 3 takes Lb, Lk <= {HIGHL_MAX_SIDE}, got ({Lb}, {Lk})")
    highl = max(Lb, Lk) > KERNEL_MAX_SIDE
    if trans is not None and not highl:
        raise ValueError(f"a side is chosen for the high-L part only, not ({Lb}, {Lk})")
    nt = len(ti)
    out = torch.empty((nt, T1 * E1.shape[2], T2 * E2.shape[2]), dtype=torch.float64, device=dev)
    if nt == 0:
        return out
    offsets = _offsets(ti, tj, offsets, dev)
    if ket is None:
        bra, ket = all_prims(E1.shape[0], E1.shape[1], T1, dev), all_prims(N2, c, T2, dev)
    sides = [(Lb, E1, p1, P1, offsets[0], T1, bra, E1t), (Lk, E2, p2, P2, offsets[1], T2, ket, E2t)]
    trans = swap_sides(Lb, Lk) if trans is None else bool(trans)
    if trans:  # the transposed blocks, the class pair seen from its ket side
        sides.reverse()
        if bra.T != T1 or (np.asarray(ti) % T1).any():
            raise ValueError(f"bra tiles must start at multiples of T1={T1}, with counts for T1")
    (Lx, Ex, px, Px, tx, Tx, nx, _), (Ly, Ey, py, Py, ty, Ty, ny, Eyt) = sides
    a, A, (N2y, cy, Cy, Sy) = Ex.shape[1], Ex.shape[2], Ey.shape
    if Eyt is None:
        Eyt = ket_layout(Ey, highl)
    elif (Eyt.shape != ((N2y, cy, Sy, Cy) if highl else (cy, Cy, Sy, N2y)) or not Eyt.is_contiguous()
          or Eyt.device != dev):
        raise ValueError("E1t and E2t must be ket_layout(E) of their class, contiguous, on E1's device")
    with torch.cuda.device(dev):
        if highl:
            sc = values_highl_schedule(Lx, Ly, a, cy, A, Cy, Tx, Ty, nt, _sm_count(dev))
            VALUES_HIGHL_KERNEL.launch(Lx, Ly, a, cy, A, Cy, Tx, Ty, nt, int(trans), sc.Ah, sc.G,
                                       sc.W, sc.NI, sc.KB, sc.NT,
                                       values_highl_smem_bytes(Lx, Ly, cy, Cy, sc), Ex.data_ptr(),
                                       px.data_ptr(), Px.data_ptr(), Eyt.data_ptr(), py.data_ptr(),
                                       Py.data_ptr(), tx.data_ptr(), ty.data_ptr(),
                                       nx.n.data_ptr(), ny.n.data_ptr(),
                                       _device_plan(Lx, Ly, dev).data_ptr(), out.data_ptr(),
                                       stream_of(out))
            return out
        VALUES_KERNEL.launch(Lx, Ly, a, cy, A, Cy, Tx, Ty, nt, N2y, int(trans), Ex.data_ptr(),
                             px.data_ptr(), Px.data_ptr(), Eyt.data_ptr(), py.data_ptr(),
                             Py.data_ptr(), tx.data_ptr(), ty.data_ptr(), nx.n.data_ptr(),
                             ny.n.data_ptr(), ny.order.data_ptr(), ny.nreal.data_ptr(),
                             ny.pos.data_ptr(), out.data_ptr(), stream_of(out))
    return out


def boys_on_card(mmax: int, T: torch.Tensor) -> torch.Tensor:
    """F_0..F_mmax at the points of the CUDA tensor T (1-d float64), by the
    kernels' own device Boys function (``csrc/boys.cuh``): (mmax+1, n), to
    hold against ``boys.boys``."""
    if T.device.type != "cuda" or T.dtype != torch.float64 or T.ndim != 1 or not T.is_contiguous():
        raise ValueError("boys_on_card needs a contiguous 1-d float64 CUDA tensor")
    if not 0 <= mmax <= KERNEL_MAX_L:
        raise ValueError(f"mmax must lie in 0..{KERNEL_MAX_L}, got {mmax}")
    F = torch.empty((mmax + 1, T.numel()), dtype=torch.float64, device=T.device)
    with torch.cuda.device(T.device):
        BOYS_PROBE.launch(mmax, T.numel(), T.data_ptr(), F.data_ptr(), stream_of(F))
    return F
