"""The partition mesh of the distributed engine (from
gandiva_tpu.parallel.mesh).

The reference runs a per-shard body under ``jax.shard_map`` over a 1-axis
device mesh and calls collectives in mid-body. The port runs eagerly, so a
``Mesh`` is P partitions of which this process holds a contiguous block:
all P with no process group (every partition on one device, as 4
partitions of one card), or P / world_size of them under a
``torch.distributed`` group (gloo on the CPU, NCCL with one card per
process). Every per-shard array of the reference becomes a list with one
tensor per held partition; the operators loop over the held partitions for
local work and call the mesh's collectives between the loops, so there are
no threads and the launch order is fixed.

Layouts follow the reference: ``all_to_all`` takes per partition a
``[P, cap, ...]`` send buffer whose block d goes to partition d, and gives
per partition a ``[P, cap, ...]`` receive buffer whose block s came from
partition s; ``all_gather`` concatenates every partition's tensor in mesh
order; ``psum`` / ``pmax`` reduce over all partitions. Reductions and
gathers return one tensor, the same on every process, where the reference
returns one replicated value per shard. ``all_to_all_rows`` is the
exchange sized by its counts: this process's rows in one buffer, as many
for each process as the caller counted, with no padding.

Each collective between processes is a device span
``gt.collective.<all_to_all|all_gather|all_reduce>`` (``tracing.py``) with
the counters ``bytes_off_card``, the blocks this process sends to the
others, and ``bytes_on_card``, its own block (an all-reduce counts a
reduce-scatter and an all-gather: 2·(W−1)/W of the tensor off the card).

``join_group`` and ``leave_group`` start and end this process's part in a
group of processes, the same way in the tests' workers and the
benchmark's: a finite timeout, so that a rank waiting on one that died
raises, and at the end a barrier before the group is destroyed, so that
no rank tears its group down while another still talks to it.
"""
from __future__ import annotations

import datetime
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .. import tracing
from ..device import DEFAULT_DEVICE, resolve_device

PARTITION_AXIS = "p"


def _wire(t: torch.Tensor) -> torch.Tensor:
    """A tensor as a collective carries it: bool as uint8 (gloo and NCCL
    take every other dtype the operators move)."""
    return t.view(torch.uint8) if t.dtype == torch.bool else t


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class Mesh:
    """``size`` partitions; this process holds ``local`` of them, the
    partitions ``first .. first + local - 1``, on ``device``."""

    def __init__(self, num_partitions: int, device: torch.device,
                 group=None):
        world = 1 if group is None else dist.get_world_size(group)
        rank = 0 if group is None else dist.get_rank(group)
        if num_partitions < 1 or num_partitions % world:
            raise ValueError(f"{num_partitions} partitions do not divide "
                             f"over {world} processes")
        self.size = num_partitions
        self.device = device
        self.group = group
        self.world = world
        self.local = num_partitions // world
        self.rank = rank
        self.first = rank * self.local

    @property
    def num_cards(self) -> int:
        """Cards the mesh spans: one a process on CUDA, none on the CPU."""
        return self.world if self.device.type == "cuda" else 0

    def index(self, i: int) -> int:
        """The mesh index of the i-th held partition (``axis_index``)."""
        return self.first + i

    # ---- collectives -----------------------------------------------------
    def all_to_all(self, bufs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Per held partition a ``[P, cap, ...]`` send buffer → per held
        partition its ``[P, cap, ...]`` receive buffer (block s from
        partition s)."""
        send = torch.stack(list(bufs), 1)          # [P_dst, L_src, cap, ...]
        if self.group is None:
            return list(send.unbind(0))
        send = send.contiguous()
        recv = torch.empty_like(send)
        with tracing.span("gt.collective.all_to_all", device=self.device):
            own = _nbytes(send) // self.world
            tracing.add("bytes_off_card", _nbytes(send) - own)
            tracing.add("bytes_on_card", own)
            dist.all_to_all_single(_wire(recv), _wire(send),
                                   group=self.group)
        # recv[r·L + j] holds rank r's L source blocks for held partition j
        recv = recv.view(self.world, self.local, *send.shape[1:])
        return [recv[:, j].reshape(self.size, *send.shape[2:])
                for j in range(self.local)]

    def all_to_all_rows(self, send: torch.Tensor, send_splits: List[int],
                        recv_splits: List[int]) -> torch.Tensor:
        """This process's rows ordered by destination process,
        ``send_splits[r]`` of them for process r → the rows every process
        sent here, ``recv_splits[r]`` of them from process r, in process
        order. Buffers hold the rows that move and no more; with no group
        the rows stay where they are."""
        if self.group is None:
            return send
        send = send.contiguous()
        recv = send.new_empty((sum(recv_splits),) + tuple(send.shape[1:]))
        row = _nbytes(send[:1]) if send.shape[0] else 0
        with tracing.span("gt.collective.all_to_all", device=self.device):
            own = send_splits[self.rank] * row
            tracing.add("bytes_off_card", sum(send_splits) * row - own)
            tracing.add("bytes_on_card", own)
            dist.all_to_all_single(_wire(recv), _wire(send), recv_splits,
                                   send_splits, group=self.group)
        return recv

    def all_gather(self, xs: Sequence[torch.Tensor]) -> torch.Tensor:
        """Every partition's tensor, concatenated in mesh order."""
        local = torch.cat(list(xs))
        if self.group is None:
            return local
        parts = [torch.empty_like(local) for _ in range(self.world)]
        with tracing.span("gt.collective.all_gather", device=self.device):
            tracing.add("bytes_off_card", _nbytes(local) * (self.world - 1))
            tracing.add("bytes_on_card", _nbytes(local))
            dist.all_gather([_wire(p) for p in parts], _wire(local),
                            group=self.group)
        return torch.cat(parts)

    def _reduce(self, xs, op: str) -> torch.Tensor:
        dtype = xs[0].dtype
        stacked = torch.stack([x.to(torch.int32) if dtype == torch.bool
                               else x for x in xs])
        out = stacked.sum(0) if op == "sum" else stacked.amax(0)
        if self.group is not None:
            with tracing.span("gt.collective.all_reduce",
                              device=self.device):
                n = _nbytes(out)
                tracing.add("bytes_off_card",
                            2 * n * (self.world - 1) // self.world)
                tracing.add("bytes_on_card", n // self.world)
                dist.all_reduce(out, op=dist.ReduceOp.SUM if op == "sum"
                                else dist.ReduceOp.MAX, group=self.group)
        return out > 0 if dtype == torch.bool else out

    def psum(self, xs: Sequence[torch.Tensor]) -> torch.Tensor:
        """The elementwise sum over every partition's tensor."""
        return self._reduce(list(xs), "sum")

    def pmax(self, xs: Sequence[torch.Tensor]) -> torch.Tensor:
        """The elementwise max over every partition's tensor (any, for
        bool)."""
        return self._reduce(list(xs), "max")


def make_mesh(num_partitions: Optional[int] = None, device=DEFAULT_DEVICE,
              group=None) -> Mesh:
    """A 1-axis partition mesh on ``device`` (the card unless the caller
    asks for the CPU). ``group``: a ``torch.distributed`` process group
    over which the partitions divide; by default the default group when
    ``torch.distributed`` is initialized, else none (this process holds all
    partitions). ``num_partitions`` defaults to one a process."""
    dev = resolve_device(device)
    if group is None and dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
    if num_partitions is None:
        num_partitions = 1 if group is None else dist.get_world_size(group)
    return Mesh(num_partitions, dev, group)


def join_group(backend: str, port: int, world: int, rank: int,
               timeout_s: float, device=None) -> None:
    """Join the default group of ``world`` processes on this host as
    ``rank`` (``tcp://localhost:<port>``), with a finite ``timeout_s`` for
    every collective: a rank left waiting on one that died raises instead
    of hanging. ``device``: this process's card, for NCCL."""
    kw = {"device_id": torch.device(device)} \
        if backend == "nccl" and device is not None else {}
    dist.init_process_group(
        backend, init_method=f"tcp://localhost:{port}", world_size=world,
        rank=rank, timeout=datetime.timedelta(seconds=timeout_s), **kw)


def leave_group() -> None:
    """End this process's part in the default group: wait at a barrier for
    every rank, then destroy the group (and every subgroup), so that no
    rank tears down its side while another still talks to it."""
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


def held(mesh: Mesh, x) -> List[torch.Tensor]:
    """``x`` as this process's partitions: a list or tuple with one tensor
    per held partition, on the mesh's device, as given (the form in which
    no process needs the whole table); a global column (numpy array or
    tensor) split by ``shard``."""
    if isinstance(x, (list, tuple)):
        if len(x) != mesh.local:
            raise ValueError(f"{len(x)} partitions given; this process "
                             f"holds {mesh.local}")
        return list(x)
    return shard(mesh, x)


def shard(mesh: Mesh, x) -> List[torch.Tensor]:
    """A global column (numpy array or tensor) split into ``mesh.size``
    equal pieces: this process's pieces, on the mesh's device — the
    counterpart of ``device_put`` with a sharding over the partition
    axis."""
    n = x.shape[0]
    if n % mesh.size:
        raise ValueError(f"{n} rows do not split into {mesh.size} equal "
                         "partitions")
    per = n // mesh.size
    lo, hi = mesh.first * per, (mesh.first + mesh.local) * per
    mine = x[lo:hi]
    if isinstance(mine, np.ndarray):
        mine = torch.from_numpy(np.ascontiguousarray(mine))
    mine = mine.to(mesh.device)
    return list(mine.split(per)) if per else [mine] * mesh.local


def unshard(mesh: Mesh, xs: Sequence[torch.Tensor]) -> torch.Tensor:
    """Per-partition outputs concatenated in mesh order, across processes
    too (every partition's output has the same shape)."""
    return mesh.all_gather(xs)
