"""Group-id assignment: exact distinct-key discovery (from
gandiva_tpu.ops.groupby).

``group_ids`` builds an open-addressing hash table with iterated claim and
re-read rounds, as the reference does:

  round i: unresolved rows probe slot (h(key) + i·step) mod T;
           rows whose slot is unoccupied write their key there (one writer
           wins);
           every unresolved row re-reads: if the slot now holds its key it
           resolves to that slot; otherwise it probes on.

Occupancy is a separate bool table, so no key value serves as a sentinel.
Which of two racing writers wins is the device's choice (``index_put_``),
so gids are a partition of the rows whose numbering may differ from the
reference's; the key set, the count and the overflow flag are exact. With
``deterministic=True`` the highest row index wins, as the last writer does
in XLA's scatter on the CPU, so slots, gids and the key order equal the
reference's on any device (the distributed hot-key detection needs the
same answer on every process; it costs an atomic max a row and round).
Its caller's sample may fill the table. Once every slot is taken no row can
claim one; a row still unresolved then settles where its key already is or
nowhere, so with ``deterministic`` one lookup in the sorted table ends the
loop with the slots the remaining rounds would give.

``distinct_small`` finds the distinct keys of a low-cardinality column in
ascending order and assigns gids by ``searchsorted`` on that table, O(N)
memory (the reference compares every row with every group, [N, G]).

Keys of any integer, bool or float dtype map to int64 by ``key_to_i64``;
torch's uint16/32/64 tensors are taken as unsigned columns.
"""
from __future__ import annotations

import torch

from ..utils.hashing import hash32
from ..utils.ints import widen
from .sort import normalize_key

_I64_MAX = (1 << 63) - 1


def table_size_for(max_groups: int, table_factor: int = 4) -> int:
    T = 1
    while T < max_groups * table_factor:
        T *= 2
    return T


def key_to_i64(keys: torch.Tensor) -> torch.Tensor:
    """Any key column → int64 with an equality-preserving bijection: floats
    through ``normalize_key`` (so 1.5 and 1.7 stay apart, and -0.0/NaN fall
    into SQL equality classes), uint32 zero-extended, uint64 as its bits."""
    if keys.dtype == torch.float32:
        return normalize_key(keys).to(torch.int64) & 0xFFFF_FFFF
    if keys.dtype == torch.float64:
        return normalize_key(keys)
    return widen(keys)


def group_ids(keys: torch.Tensor, valid=None, max_groups: int = 4096,
              table_factor: int = 4, deterministic: bool = False):
    """Assign dense group ids to ``keys``.

    Returns (gid[N] int32, unique_keys[T] int64, group_count, overflow):
    - gid ∈ [0, group_count) for valid rows; T for invalid rows;
    - unique_keys: the distinct keys (as ``key_to_i64`` images) in gid
      order, tail zero;
    - group_count: 0-d int32; overflow: 0-d bool, set when the probe budget
      ran out (the caller retries with a larger ``max_groups``).
    ``deterministic``: the highest row index wins a contended slot, so the
    numbering is the reference's (module docstring).
    The loop tests on the host after each round whether a row is still
    unresolved, and with ``deterministic`` whether the table is full (one
    sync per round; about two rounds at T ≥ 4·G).
    """
    n = keys.shape[0]
    dev = keys.device
    T = table_size_for(max_groups, table_factor)
    keys = key_to_i64(keys)
    unresolved = (torch.ones(n, dtype=torch.bool, device=dev) if valid is None
                  else valid.clone())
    table_key = torch.zeros(T + 1, dtype=torch.int64, device=dev)
    table_occ = torch.zeros(T + 1, dtype=torch.bool, device=dev)
    pos = hash32(keys) % T
    # double hashing: odd stride (full cycle in the power-of-2 table)
    step = (hash32(keys, 0x9E37) % T) | 1
    slot_of = torch.full((n,), T, dtype=torch.int64, device=dev)
    dump = torch.full((n,), T, dtype=torch.int64, device=dev)
    rows = torch.arange(n, device=dev) if deterministic else None
    for _ in range(T):
        if deterministic:
            pending, full = torch.stack([unresolved.any(),
                                         table_occ[:T].all()]).tolist()
        else:
            pending, full = bool(unresolved.any()), False
        if not pending:
            break
        if full:
            slot_of, unresolved = _settle_in_full_table(
                table_key[:T], keys, unresolved, slot_of)
            break
        slot = torch.where(unresolved, pos, dump)  # parked rows: the dump
        claim = unresolved & ~table_occ[slot]
        won = _highest_claimer(claim, slot, rows, T) if deterministic \
            else torch.where(claim, slot, dump)
        table_key.index_put_((won,), keys)
        table_occ.index_put_((won,),
                             torch.ones((), dtype=torch.bool, device=dev))
        settled = unresolved & table_occ[slot] & (table_key[slot] == keys)
        slot_of = torch.where(settled, slot, slot_of)
        unresolved = unresolved & ~settled
        pos = (pos + step) % T
    overflow = unresolved.any()

    filled = table_occ[:T]
    filled32 = filled.to(torch.int32)
    rank = torch.cumsum(filled32, 0, dtype=torch.int32) - filled32
    group_count = filled32.sum(dtype=torch.int32)
    gid = torch.where(slot_of < T, rank[slot_of.clamp(max=T - 1)], T)
    if valid is not None:
        gid = torch.where(valid, gid, T)
    uniq = torch.zeros(T + 1, dtype=torch.int64, device=dev)
    uniq.index_put_((torch.where(filled, rank, T).to(torch.int64),),
                    table_key[:T])
    return gid.to(torch.int32), uniq[:T], group_count, overflow


def _highest_claimer(claim, slot, rows, T: int):
    """The slot each row writes: its own where it is the highest row index
    claiming that slot, else the dump slot T. Rows that claim nothing reduce
    into 1024 spare slots past the dump, so they do not all contend for one
    address."""
    spare = T + 1 + (rows & 1023)
    target = torch.where(claim, slot, spare)
    winner = torch.full((T + 1025,), -1, dtype=torch.int64, device=slot.device)
    winner.scatter_reduce_(0, target, rows, "amax")
    return torch.where(claim & (winner[target] == rows), slot, T)


def _settle_in_full_table(table_keys, keys, unresolved, slot_of):
    """Settle each unresolved row in the slot that holds its key, if one
    does: in a full table each key holds one slot, and an odd stride visits
    every slot within T rounds, so this is where the loop would put it."""
    sorted_keys, order = torch.sort(table_keys)
    at = torch.searchsorted(sorted_keys, keys).clamp(
        max=sorted_keys.shape[0] - 1)
    found = unresolved & (sorted_keys[at] == keys)
    return (torch.where(found, order[at], slot_of),
            unresolved & ~found)


def group_ids_multi(key_columns, valids=None, max_groups: int = 4096,
                    table_factor: int = 4):
    """Composite-key group ids, exact for any number of key columns.

    Each column resolves to its own dense id; ids combine pairwise as
    ``gid_a * (max_groups+2) + gid_b`` and re-densify through the same
    table. Null keys get their own id per column (SQL GROUP BY groups nulls
    together). Returns (gid[N], group_count, overflow).
    """
    if valids is None:
        valids = [None] * len(key_columns)
    base = max_groups + 2

    combined = None
    overflow = None
    for k, (col, valid) in enumerate(zip(key_columns, valids)):
        gid, _, _, ov = group_ids(col, None, max_groups=max_groups,
                                  table_factor=table_factor)
        overflow = ov if overflow is None else overflow | ov
        if valid is not None:  # null keys form their own per-column id
            gid = torch.where(valid, gid, max_groups + 1)
        g64 = gid.to(torch.int64)
        combined = g64 if combined is None else combined * base + g64
        if k < len(key_columns) - 1:
            # re-densify between stages so the product stays in range
            combined, _, _, ov2 = group_ids(combined, None,
                                            max_groups=max_groups,
                                            table_factor=table_factor)
            overflow = overflow | ov2
            combined = combined.to(torch.int64)

    gid, _, gcount, ov3 = group_ids(combined, None, max_groups=max_groups,
                                    table_factor=table_factor)
    return gid, gcount, overflow | ov3


def distinct_small(keys: torch.Tensor, valid=None, max_groups: int = 256):
    """Distinct keys and dense gids for LOW-cardinality columns, in
    ascending order of the ``key_to_i64`` image.

    Returns (gid[N] int32, uniq[max_groups] int64, count, overflow), the
    contract of ``group_ids``: ``uniq`` holds the ``max_groups`` smallest
    distinct keys other than int64::max, padded with int64::max; the
    int64::max key, when present, takes the gid after them; rows whose key
    is not among them get gid T and set ``overflow``.
    """
    n = keys.shape[0]
    dev = keys.device
    k64 = key_to_i64(keys)
    if valid is None:
        valid = torch.ones(n, dtype=torch.bool, device=dev)
    is_max = valid & (k64 == _I64_MAX)
    distinct = torch.unique(k64[valid & ~is_max], sorted=True)
    found = distinct[:max_groups]
    count = (torch.tensor(found.shape[0], dtype=torch.int32, device=dev)
             + is_max.any().to(torch.int32))
    uniq = torch.full((max_groups,), _I64_MAX, dtype=torch.int64, device=dev)
    uniq[:found.shape[0]] = found
    pos = torch.searchsorted(uniq, k64).clamp(max=max_groups - 1)
    matched = uniq[pos] == k64
    gid = torch.where(is_max, count - 1, pos)
    T = table_size_for(max_groups)
    gid = torch.where(valid & (matched | is_max), gid, T)
    overflow = (valid & ~matched & ~is_max).any()
    return gid.to(torch.int32), uniq, count, overflow
