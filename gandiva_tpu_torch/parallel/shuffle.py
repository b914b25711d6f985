"""Distributed shuffle — all-to-all repartition over the partition mesh
(from gandiva_tpu.parallel.shuffle).

Each partition buckets its rows by destination partition into
fixed-capacity send buffers (the SelectionVector idea in 2-D), then one
``Mesh.all_to_all`` moves them. Row counts ride alongside as a
per-partition count vector; capacity overflow is a flag, max-reduced over
the mesh, that the host turns into a retry (Status-style, SURVEY.md §5.3).

Layout contract: every per-partition table is ``(values[N], valid[N])``
columns; after ``exchange``, rows from source partition s live in block s
of each partition's ``[P, cap]`` receive buffer, ``recv_counts[s]`` of
them. Each argument that the reference takes per shard is here a list with
one tensor per held partition. The sort, the counts and the gathers are
ordinary torch operations: no kernel of the TPU package is involved.
"""
from __future__ import annotations

from typing import Dict, List

import torch

from ..utils.hashing import partition_of
from ..utils.ints import signed_view
from .mesh import Mesh


def bucket_by_partition(part_ids: torch.Tensor, valid: torch.Tensor,
                        payload: Dict[str, torch.Tensor],
                        num_partitions: int, capacity: int):
    """Pack one partition's rows into ``[P, capacity]`` send buffers grouped
    by partition id.

    Returns (send: {name: [P, cap]}, counts: int32[P], overflow: 0-d bool).
    Rows with ``valid`` false go to bucket P and are dropped. Stable within
    each partition; unfilled slots are zero."""
    n = part_ids.shape[0]
    P = num_partitions
    dev = part_ids.device
    part = torch.where(valid, part_ids.to(torch.int32), P)
    order = torch.sort(part, stable=True).indices
    counts = torch.bincount(part, minlength=P + 1)[:P]
    start = torch.cumsum(counts, 0) - counts
    # slot (p, s) takes sorted row start[p] + s while s < counts[p]
    s = torch.arange(capacity, device=dev)
    filled = s[None, :] < counts[:, None]
    src = torch.where(filled, start[:, None] + s[None, :], 0).reshape(-1)
    rows = order.index_select(0, src) if n else src
    send = {}
    for name, col in payload.items():
        w = signed_view(col)
        g = (w.index_select(0, rows) if n else
             w.new_zeros((P * capacity,) + tuple(w.shape[1:])))
        g = g.view(P, capacity, *w.shape[1:])
        keep = filled.view(P, capacity, *([1] * (w.dim() - 1)))
        send[name] = torch.where(keep, g, w.new_zeros(())).view(col.dtype)
    overflow = (counts > capacity).any()
    return send, counts.clamp(max=capacity).to(torch.int32), overflow


def exchange(part_ids: List[torch.Tensor], valid: List[torch.Tensor],
             payload: Dict[str, List[torch.Tensor]], mesh: Mesh,
             capacity: int):
    """Bucket every held partition's rows, then ``all_to_all``.

    Returns (recv: {name: [per partition [P, cap]]}, recv_counts: [per
    partition int32[P]], overflow: 0-d bool over the whole mesh). Block s
    of a receive buffer came from partition s."""
    sends = [bucket_by_partition(part_ids[i], valid[i],
                                 {name: cols[i]
                                  for name, cols in payload.items()},
                                 mesh.size, capacity)
             for i in range(mesh.local)]
    recv = {name: mesh.all_to_all([s[0].pop(name) for s in sends])
            for name in payload}
    recv_counts = mesh.all_to_all([s[1] for s in sends])
    overflow = mesh.pmax([s[2] for s in sends])
    return recv, recv_counts, overflow


def flatten_received(recv: Dict[str, List[torch.Tensor]],
                     recv_counts: List[torch.Tensor]):
    """``[P, cap]`` receive buffers → flat ``[P*cap]`` columns and each
    partition's row validity."""
    flat = {name: [b.reshape(b.shape[0] * b.shape[1], *b.shape[2:])
                   for b in bufs]
            for name, bufs in recv.items()}
    cap = next(iter(recv.values()))[0].shape[1]
    valid = []
    for c in recv_counts:
        within = torch.arange(cap, device=c.device)
        valid.append((within[None, :] < c[:, None]).reshape(-1))
    return flat, valid


def shuffle_by_key(keys: List[torch.Tensor], valid: List[torch.Tensor],
                   payload: Dict[str, List[torch.Tensor]], mesh: Mesh,
                   capacity: int, seed: int = 0):
    """Hash-partition rows by key and exchange: the engine's repartition
    primitive. Returns (flat payload {name: [per partition [P*cap]]}, flat
    validity per partition, overflow)."""
    part = [partition_of(k, mesh.size, seed) for k in keys]
    recv, recv_counts, overflow = exchange(part, valid, payload, mesh,
                                           capacity)
    flat, flat_valid = flatten_received(recv, recv_counts)
    return flat, flat_valid, overflow
