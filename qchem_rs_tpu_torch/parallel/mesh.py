"""Process meshes for more than one device (port of
``qchem_rs_tpu/parallel/mesh.py``).

The JAX package runs one process over many devices: a ``Mesh`` of them,
and ``shard_map`` with ``psum``/``all_gather`` or GSPMD shardings of the
operands. The port runs one process per device under
``torch.distributed`` (NCCL between cards, gloo on the CPU), launched by
``torchrun``: each rank computes its share and collectives combine the
shares (``all_reduce`` for ``psum``, ``all_gather`` for ``all_gather``).
Dense SCF algebra stays replicated on every rank, as in the JAX package.

A ``Mesh`` holds this process's rank, the group's size, the process group
and the device. A mesh of size 1 with no group is the one-device mesh: its
collectives are the identity. A mesh of size > 1 with no group is a *rank
view*: it computes one rank's share inside the calling process and runs no
collective (its collectives raise). The sharded builders return a rank
view's local partials (``jk_partial``) for a caller that adds them in rank
order, which holds the partition logic on one card or on the CPU, as the
JAX package's 8-way virtual CPU mesh does.
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist

from qchem_rs_tpu_torch.models.rhf import check_device

#: torchrun's variables that ``distributed_init`` reads
TORCHRUN_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank of a 1D device mesh: ``rank`` of ``size``, the process
    ``group`` (None: no collective) and this rank's ``device``."""

    rank: int
    size: int
    group: object
    device: torch.device

    def __post_init__(self):
        if not 0 <= self.rank < self.size:
            raise ValueError(f"rank {self.rank} is not in a mesh of size {self.size}")

    @property
    def is_rank_view(self) -> bool:
        return self.size > 1 and self.group is None

    def _check_collective(self) -> bool:
        """True when a collective must run, False on the one-device mesh;
        raises on a rank view."""
        if self.is_rank_view:
            raise RuntimeError(
                f"rank view {self.rank} of {self.size} runs no collective: add the views' "
                "jk_partial shares in rank order (column views: after prepare_rank_views)")
        return self.group is not None

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the ranks, in place; returns it."""
        if self._check_collective():
            dist.all_reduce(t, group=self.group)
        return t

    def all_gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """The ranks' ``t`` (equal shapes) concatenated along ``dim`` in
        rank order."""
        if not self._check_collective():
            return t
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t.contiguous(), group=self.group)
        return torch.cat(parts, dim=dim)

    def share(self, n: int) -> slice:
        """This rank's contiguous share of ``n`` items: equal shares, the
        first ``n % size`` ranks one item more."""
        q, r = divmod(n, self.size)
        start = self.rank * q + min(self.rank, r)
        return slice(start, start + q + (self.rank < r))


def rank_view(size: int, rank: int, device="cuda") -> Mesh:
    """Rank ``rank`` of a mesh of ``size``, computed in this process (no
    collective)."""
    return Mesh(rank, size, None, check_device(device))


def distributed_init(device="cuda") -> bool:
    """Join the process group that ``torchrun`` describes in MASTER_ADDR,
    MASTER_PORT, WORLD_SIZE, RANK and LOCAL_RANK (port of
    ``qchem_rs_tpu/parallel/mesh.py:15-49``). Without those variables, or
    with a world size of 1 or less, a no-op returning False. Safe to call
    twice. On CUDA it picks NCCL and binds ``cuda:LOCAL_RANK``, raising
    without CUDA (there is no fallback to gloo on a card); with
    ``device="cpu"`` it picks gloo."""
    if any(k not in os.environ for k in TORCHRUN_ENV) or int(os.environ["WORLD_SIZE"]) <= 1:
        return False
    if dist.is_initialized():
        return True
    device = check_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method="env://",
                            world_size=int(os.environ["WORLD_SIZE"]),
                            rank=int(os.environ["RANK"]))
    return True


def data_mesh(n_devices: int | None = None, device="cuda") -> Mesh:
    """The mesh of this process's group (NCCL: its bound card; gloo: the
    CPU), or, when no group is up, the one-device mesh on ``device``.
    ``n_devices``, when given, must be the group's size: the launcher, not
    the caller, sets the number of devices."""
    device = check_device(device)
    if dist.is_initialized():
        if dist.get_backend() == "nccl":
            mesh_device = torch.device("cuda", torch.cuda.current_device())
        else:
            mesh_device = torch.device("cpu")
        if mesh_device.type != device.type:
            raise ValueError(f"the process group runs on {mesh_device}, not {device}")
        mesh = Mesh(dist.get_rank(), dist.get_world_size(), dist.group.WORLD, mesh_device)
    else:
        mesh = Mesh(0, 1, None, device)
    if n_devices is not None and n_devices != mesh.size:
        raise ValueError(f"the mesh has {mesh.size} devices, not {n_devices}")
    return mesh
