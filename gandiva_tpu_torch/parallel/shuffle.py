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

``exchange_sized`` is the same exchange sized by the rows that move, the
engine's own path (a capacity is then no guess and never overflows): every
partition counts its rows per destination, the counts go round the mesh
and the host reads them once (``gt.sync.exchange_counts``), and each
buffer then holds exactly the rows it carries. A partition receives the
rows of source s in block s as above, the blocks back to back with no
padding: the rows of the ``[P, cap]`` layout where it is valid, in the
same order.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch

from .. import tracing
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
    with tracing.sync("bincount"):
        tracing.add("reads", 2)           # on a card: part's min and max
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


def exchange_sized(part_ids: List[torch.Tensor], valid: List[torch.Tensor],
                   payload: Dict[str, List[torch.Tensor]], mesh: Mesh):
    """``exchange`` with buffers sized by the rows that move.

    Returns ({name: [per held partition its received rows]}, [per held
    partition the number of rows received]): block s of a partition's
    rows came from partition s, in that partition's order."""
    P, L, W = mesh.size, mesh.local, mesh.world
    dev = part_ids[0].device
    # a row's sort key: its destination d, then its held source i (d·L +
    # i), rows outside ``valid`` last; sorted, this process's rows are its
    # send buffer: by destination process, then destination, then source
    keys = [torch.where(valid[i], part_ids[i].to(torch.int32) * L + i,
                        P * L) for i in range(L)]
    kdt = torch.uint8 if P * L < 256 else torch.int32
    skey, order = torch.sort((keys[0] if L == 1 else torch.cat(keys))
                             .to(kdt), stable=True)
    bounds = torch.searchsorted(skey, torch.arange(P * L + 1, device=dev,
                                                   dtype=kdt))
    every = mesh.all_gather([bounds[1:] - bounds[:-1]])
    with tracing.sync("exchange_counts"):
        c = every.tolist()

    def n(s: int, d: int) -> int:
        """Rows of partition s for partition d."""
        return c[((s // L) * P + d) * L + s % L]

    me, mine = mesh.rank, range(mesh.first, mesh.first + L)
    send_splits = [sum(n(me * L + i, d) for d in range(r * L, r * L + L)
                       for i in range(L)) for r in range(W)]
    recv_splits = [sum(n(r * L + i, d) for d in mine for i in range(L))
                   for r in range(W)]
    sizes = [sum(n(s, d) for s in range(P)) for d in mine]
    # rows from process r arrive by destination, then r's source; with
    # several processes each holding several partitions, regroup them by
    # destination: the blocks of each destination, source by source
    segs = [[] for _ in mine]
    if W > 1 and L > 1:
        at = 0
        for r in range(W):
            for j, d in enumerate(mine):
                for i in range(L):
                    segs[j].append((at, n(r * L + i, d)))
                    at += segs[j][-1][1]
    rows = order[:sum(send_splits)]
    out = {}
    for name, cols in payload.items():
        w = signed_view(cols[0]) if L == 1 else \
            torch.cat([signed_view(x) for x in cols])
        recv = mesh.all_to_all_rows(w.index_select(0, rows), send_splits,
                                    recv_splits).view(cols[0].dtype)
        out[name] = ([torch.cat([recv.narrow(0, a, k) for a, k in seg])
                      for seg in segs] if segs[0] else
                     list(recv.split(sizes)))
    return out, sizes


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
                   capacity: Optional[int], seed: int = 0):
    """Hash-partition rows by key and exchange: the engine's repartition
    primitive. Returns (flat payload {name: [per partition [P*cap]]}, flat
    validity per partition, overflow); with ``capacity`` None the exchange
    is sized by its rows (``exchange_sized``): each partition's rows, all
    valid, and no overflow."""
    part = [partition_of(k, mesh.size, seed) for k in keys]
    return exchange_flat(part, valid, payload, mesh, capacity)


def exchange_flat(part_ids, valid, payload, mesh: Mesh,
                  capacity: Optional[int]):
    """``exchange`` then ``flatten_received`` (``capacity`` an int), or
    ``exchange_sized`` (``capacity`` None): (flat payload, flat validity,
    overflow). The sized exchange adds the counters ``slots`` (rows its
    receive buffers hold) and ``rows`` (rows that moved) to the innermost
    open span, the caller's ``gt.exchange``."""
    if capacity is not None:
        recv, recv_counts, overflow = exchange(part_ids, valid, payload,
                                               mesh, capacity)
        flat, flat_valid = flatten_received(recv, recv_counts)
        return flat, flat_valid, overflow
    dev = part_ids[0].device
    flat, sizes = exchange_sized(part_ids, valid, payload, mesh)
    # the buffers hold the rows that moved and no more
    tracing.add("slots", sum(sizes))
    tracing.add("rows", sum(sizes))
    return (flat, [torch.ones(k, dtype=torch.bool, device=dev)
                   for k in sizes],
            torch.zeros((), dtype=torch.bool, device=dev))
