"""Distributed operators: shuffle-composed join / aggregate / sort (from
gandiva_tpu.parallel.ops).

Tables are hash-partitioned over the partition mesh; operators run per
partition on co-partitioned data after an all-to-all shuffle, and results
are exact because equal keys land on the same partition (same hash seed ⇒
co-partitioning). Each function is the reference's per-shard body with the
mesh in place of the axis name and, in place of each per-shard array, a
list with one tensor per held partition (``{name: (values, validity)}``
dicts hold such lists); results come back the same way. Local work runs
the port's operators: ``ops.join`` (kernels K4 and K3 build the table, K2
compacts a large probe's residue), ``gather_payload``, ``hash_aggregate``
(K5 on a card at up to 1024 groups), ``group_ids``, ``sort_permutation``.

64-bit columns ride the exchange whole: the reference's 32-bit limb pairs
(``utils/bits``) were a TPU workaround.

Every capacity (``capacity``, ``probe_capacity``, ``build_capacity``,
``out_capacity``) may be None: the exchange is then sized by the rows that
move (``shuffle.exchange_sized``) and the local join's output by the
pairs it emits (``ops.join`` with no capacity), so nothing overflows but
the hot-key replication's ``hot_replicate_capacity`` and the aggregate's
``max_groups``. A partition then holds the rows that arrived, all valid,
and the partitions' lengths differ. An int keeps the reference's
``[P*cap]`` layouts.

Distributed sort uses sampled range partitioning: every partition
contributes a key sample, splitters are the global sample quantiles, rows
shuffle to their range's partition, and a local sort per partition yields
a globally sorted table (partition p holds keys ≤ partition p+1's).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from .. import tracing
from ..ops.compaction import compact_sort
from ..ops.groupby import group_ids, key_to_i64
from ..ops.hash_aggregate import hash_aggregate
from ..ops.hash_join import JoinResult, gather_payload, join
from ..ops.kernels.key_table import is_in_table_cuda
from ..ops.sort import SortKey, _take, normalize_key, sort_permutation
from ..utils.hashing import partition_of
from ..utils.ints import UNSIGNED_VIEW, signed_view
from .mesh import Mesh
from .shuffle import exchange_flat

_UNSIGNED_OF = {v: k for k, v in UNSIGNED_VIEW.items()}


def _pick(cols: Dict[str, Tuple], i: int) -> Dict[str, Tuple]:
    """Partition i's ``{name: (values, validity)}`` out of per-partition
    lists."""
    return {n: (v[i], None if vv is None else vv[i])
            for n, (v, vv) in cols.items()}


def _lists(items: List[Dict]) -> Dict[str, List]:
    """Per-partition result dicts → one dict of per-partition lists."""
    return {k: [it[k] for it in items] for k in items[0]}


def _shuffle_cols(keys, valid, cols: Dict[str, Tuple], mesh: Mesh,
                  capacity: Optional[int], part_ids=None, seed: int = 0):
    """Shuffle keys and named columns with their validity by key hash.

    ``cols[name] = (values, validity-or-None)``, each a per-partition list.
    Returns (keys, valid, cols, overflow), the first three flattened to
    ``[P*cap]`` per partition, or to the rows that arrived with
    ``capacity`` None."""
    with tracing.span("gt.exchange", device=keys[0].device):
        if part_ids is None:
            part_ids = [partition_of(k, mesh.size, seed) for k in keys]
        payload = {"__key": keys}
        for name, (vals, vv) in cols.items():
            payload[name] = vals
            if vv is not None:
                payload[f"{name}__v"] = vv
        flat, fvalid, overflow = exchange_flat(part_ids, valid, payload,
                                               mesh, capacity)
        out_cols = {name: (flat[name], flat.get(f"{name}__v"))
                    for name in cols}
        return flat["__key"], fvalid, out_cols, overflow


def dist_hash_aggregate(keys, row_valid, values: Dict[str, Tuple], aggs,
                        mesh: Mesh, capacity: Optional[int], key_valid=None,
                        max_groups: int = 4096, seed: int = 0):
    """Shuffle by key, then aggregate each partition locally.

    After the shuffle every key lives on exactly one partition, so local
    aggregation is globally exact; the partitions' outputs are disjoint
    group sets. Null keys all route to one fixed partition (the partition
    of a seed-keyed zero key) so the null group stays on one. Returns
    ``hash_aggregate``'s dict with a per-partition list under each name;
    ``overflow`` includes the shuffle's."""
    P = mesh.size
    if key_valid is None:
        key_valid = [torch.ones_like(rv) for rv in row_valid]
    null_part = partition_of(torch.zeros(1, dtype=keys[0].dtype,
                                         device=keys[0].device), P,
                             seed ^ 0x5EED)
    part = [torch.where(kv, partition_of(k, P, seed), null_part)
            for k, kv in zip(keys, key_valid)]
    kk, fvalid, cols, overflow = _shuffle_cols(
        keys, row_valid, {**values, "__kv": (key_valid, None)}, mesh,
        capacity, part_ids=part, seed=seed)
    kv = cols.pop("__kv")[0]
    out = []
    for i in range(mesh.local):
        res = hash_aggregate(kk[i], aggs, _pick(cols, i), key_valid=kv[i],
                             row_valid=fvalid[i], max_groups=max_groups)
        res["overflow"] = res["overflow"] | overflow
        out.append(res)
    return _lists(out)


def dist_join(probe_keys, probe_valid, probe_cols: Dict[str, Tuple],
              build_keys, build_valid, build_cols: Dict[str, Tuple],
              mesh: Mesh, probe_capacity: Optional[int],
              build_capacity: Optional[int], out_capacity: Optional[int],
              how: str = "inner",
              probe_key_valid=None, build_key_valid=None, seed: int = 0,
              build_unique: bool = False):
    """Co-shuffle both sides by key hash, then join each partition locally.

    Same hash seed on both sides ⇒ equal keys co-locate ⇒ the union of the
    partitions' joins is the global join. Null-key rows stay on their
    origin partition (they never match; outer-side emission is local).
    ``*_valid``: rows that exist; ``*_key_valid``: non-null keys. Returns
    (per-partition JoinResults, {name: (values, validity)} of per-partition
    lists with the probe key as ``__probe_key``, per-partition row_ok,
    per-partition overflow)."""
    P = mesh.size

    def route(keys, kv):
        return [partition_of(k, P, seed) if kv is None else
                torch.where(kv[i], partition_of(k, P, seed), mesh.index(i))
                for i, k in enumerate(keys)]

    def shuffle(keys, valid, cols, kv, capacity):
        ones = [torch.ones_like(v) for v in valid] if kv is None else kv
        k, ok, c, ov = _shuffle_cols(keys, valid, {**cols, "__kv": (ones,
                                                                    None)},
                                     mesh, capacity, part_ids=route(keys, kv),
                                     seed=seed)
        return k, ok, c, c.pop("__kv")[0], ov

    pk, pvalid, pcols, pkv, ov1 = shuffle(probe_keys, probe_valid,
                                          probe_cols, probe_key_valid,
                                          probe_capacity)
    bk, bvalid, bcols, bkv, ov2 = shuffle(build_keys, build_valid,
                                          build_cols, build_key_valid,
                                          build_capacity)
    results, outs, row_oks, overflows = [], [], [], []
    for i in range(mesh.local):
        # existence = the row arrived in the shuffle; key validity = the
        # original null mask (travelled as __kv)
        res = join(pk[i], bk[i], out_capacity, how,
                   probe_valid=pkv[i], build_valid=bkv[i],
                   probe_exists=pvalid[i], build_exists=bvalid[i],
                   build_unique=build_unique)
        cols, row_ok = gather_payload(
            res, probe_cols={**_pick(pcols, i),
                             "__probe_key": (pk[i], pvalid[i])},
            build_cols=_pick(bcols, i))
        results.append(res)
        outs.append(cols)
        row_oks.append(row_ok)
        overflows.append(ov1 | ov2 | res.overflow)
    return results, _lists_of_pairs(outs), row_oks, overflows


def _lists_of_pairs(outs: List[Dict[str, Tuple]]) -> Dict[str, Tuple]:
    """Per-partition ``{name: (values, validity)}`` → one such dict of
    per-partition lists."""
    return {name: ([o[name][0] for o in outs], [o[name][1] for o in outs])
            for name in outs[0]}


def _order_lane(norm: torch.Tensor) -> torch.Tensor:
    """A normalized lane (an unsigned value held as the bits of the signed
    type of its width) as int64 whose signed order is the lane's unsigned
    order: the sign bit flipped, then sign-extended (uint8 zero-extends)."""
    if norm.dtype == torch.uint8:
        return norm.to(torch.int64)
    info = torch.iinfo(norm.dtype)
    return (norm ^ info.min).to(torch.int64)


def dist_sort(keys, key_valid, payload: Dict[str, Tuple], mesh: Mesh,
              capacity: Optional[int], ascending: bool = True,
              nulls_first: bool = True, sample_stride: int = 64,
              exists=None):
    """Sampled range partition → shuffle → local sort.

    ``key_valid``: the non-null mask — null rows travel to the extreme
    partition and sort to the requested end. ``exists``: rows that exist
    at all (padding never travels). Returns per-partition sorted (keys,
    row_valid, key_null, payload) lists and the mesh-wide overflow;
    globally sorted across partitions in mesh order.

    Normalized lanes are unsigned values in signed storage, so splitters
    and ranks compare after ``_order_lane`` flips the sign bit; the
    reference's null rank (0 or the lane's all-ones) becomes the lane's
    extreme in that order."""
    L = mesh.local
    if exists is None:
        exists = [torch.ones(k.shape[0], dtype=torch.bool, device=k.device)
                  for k in keys]
    ranks, samples = [], []
    for i in range(L):
        norm = normalize_key(keys[i], ascending)
        # the reference's null rank, 0 or the lane's all-ones, in this order
        info = torch.iinfo(norm.dtype)
        nullv = info.min if nulls_first else info.max
        rank = torch.where(key_valid[i], _order_lane(norm), nullv)
        sample = torch.where(exists[i][::sample_stride],
                             rank[::sample_stride], nullv)
        ranks.append(rank)
        samples.append(torch.sort(sample).values)
    ssorted = torch.sort(mesh.all_gather(samples)).values
    m = ssorted.shape[0]
    cut = (torch.arange(1, mesh.size, device=ssorted.device) * m) \
        // mesh.size
    splitters = ssorted[cut]                                   # [P-1]
    part = [torch.searchsorted(splitters, r, right=True).to(torch.int32)
            for r in ranks]

    recv_keys, fvalid, cols, overflow = _shuffle_cols(
        keys, exists, {**payload, "__nullv": (key_valid, None)}, mesh,
        capacity, part_ids=part)
    key_null = [~v for v in cols.pop("__nullv")[0]]

    out_keys, out_valid, out_null, out_payload = [], [], [], []
    for i in range(L):
        # one stable sort: non-arrived slots to the back, then the null
        # placement, then the normalized key (null rows' keys pinned to 0)
        kvalid = fvalid[i] & ~key_null[i]
        nr = kvalid if nulls_first else ~kvalid
        normk = normalize_key(recv_keys[i], ascending)
        normk = torch.where(kvalid, normk, torch.zeros_like(normk))
        if normk.dtype in _UNSIGNED_OF:
            normk = normk.view(_UNSIGNED_OF[normk.dtype])
        lead = (~fvalid[i]).to(torch.int32) * 2 + nr.to(torch.int32)
        perm = sort_permutation([SortKey(lead), SortKey(normk)]).long()
        out_keys.append(_take(recv_keys[i], perm))
        out_valid.append(fvalid[i].index_select(0, perm))
        out_null.append(key_null[i].index_select(0, perm))
        out_payload.append({name: (_take(v, perm),
                                   None if vv is None
                                   else vv.index_select(0, perm))
                            for name, (v, vv) in _pick(cols, i).items()})
    return (out_keys, out_valid, out_null, _lists_of_pairs(out_payload),
            overflow)


# ---------------------------------------------------------------------------
# skew-aware join (BASELINE configs[3]: Zipfian probe keys)
# ---------------------------------------------------------------------------

def detect_hot_keys(keys, valid, mesh: Mesh, num_hot: int,
                    sample_stride: int = 64, hot_threshold: int = 4):
    """Sampled global histogram → hot-key table.

    Every partition samples its keys, the samples are all-gathered, and
    keys appearing ≥ hot_threshold times in the global sample are hot
    (SURVEY.md §5.7). Returns (hot_keys[num_hot], hot_valid[num_hot]), the
    same on every process: ``group_ids(deterministic=True)`` numbers groups
    as the reference does on any device, so the stable order by count
    breaks ties alike."""
    all_s = mesh.all_gather([k[::sample_stride] for k in keys])
    all_v = mesh.all_gather([v[::sample_stride] for v in valid])
    G = 4 * num_hot
    gid, uniq, gcount, _ = group_ids(all_s, all_v, max_groups=G,
                                     deterministic=True)
    counts = torch.zeros(G + 1, dtype=torch.int32, device=all_s.device)
    counts.index_add_(0, gid.clamp(0, G).long(),
                      torch.ones_like(gid, dtype=torch.int32))
    counts = counts[:G]
    hot = counts >= hot_threshold
    # the num_hot hottest, by count (stable: ties keep gid order)
    order = torch.sort(-counts, stable=True).indices[:num_hot]
    return uniq[order], hot[order] & (order < gcount)


def _is_in_table(keys, table_keys, table_valid):
    """Membership of each key in a small key table of ``key_to_i64``
    images (the reference compares every key with every entry).

    CUDA tensors take the kernel of ``kernels/key_table.py``, one launch
    and no host sync, and the counter ``kernel_rows`` of the open span says
    how many keys it took; CPU tensors take _is_in_table_plain."""
    if table_keys.shape[0] == 0:
        return torch.zeros(keys.shape[0], dtype=torch.bool,
                           device=keys.device)
    k, t = key_to_i64(keys), key_to_i64(table_keys)
    if k.device.type == "cuda":
        tracing.add("kernel_rows", k.shape[0])
        return is_in_table_cuda(k.contiguous(), t.contiguous(),
                                table_valid.contiguous())
    return _is_in_table_plain(k, t, table_valid)


def _is_in_table_plain(k, t, table_valid):
    """The key table's plain version on any device, over int64 keys ``k``
    and a non-empty table ``t``: the table read on the host, then
    ``torch.isin`` (which sorts the table instead of comparing every
    entry once it is large enough)."""
    # invalid entries repeat the first valid key, so they add no member
    with tracing.sync("hot_table"):       # a 0-d tensor index reads it
        first = t[torch.argmax(table_valid.to(torch.int32))]
    t = torch.where(table_valid, t, first)
    # isin sorts once the table holds 10·n^0.145 entries or more (numpy's
    # rule, which ATen keeps), and then waits three times: two unique
    # counts and a flag copied from the host; below that it does not wait
    waits = 3 if k.numel() and t.numel() >= int(10.0 * k.numel() ** 0.145) \
        else 0
    with tracing.sync("hot_isin"):
        tracing.add("reads", waits)
        return torch.isin(k, t) & table_valid.any()


def dist_join_skewed(probe_keys, probe_valid, probe_cols,
                     build_keys, build_valid, build_cols,
                     mesh: Mesh, probe_capacity: Optional[int],
                     build_capacity: Optional[int],
                     out_capacity: Optional[int], how: str = "inner",
                     num_hot: int = 64, hot_replicate_capacity: int = 1024,
                     seed: int = 0, build_unique: bool = False):
    """Skew-aware join (inner/semi/left/anti/right/full).

    Hot probe keys (from a global sample) do NOT shuffle: their probe rows
    stay on the origin partition and the matching build rows are
    replicated to every partition by all-gather. Cold keys hash-partition
    as usual, which bounds any partition's receive volume at cold_rows/P
    plus its own hot rows.

    ``probe_valid``: the probe rows that take part (a row outside it is
    not emitted). ``build_valid``: the build keys' validity; a null-key
    build row never matches, and right/full emit it as unmatched on its
    origin partition, as Acero does (the reference drops it).

    right/full: unmatched-build emission must see the GLOBAL match truth
    for replicated hot rows (a replica may match on one partition only).
    The local join runs as inner (right) / left (full), the per-partition
    hit flags over the replicated block — whose ``[P*cap_h]`` layout is
    the same on every partition — are max-reduced over the mesh, and each
    unmatched hot row emits only on its origin partition. Cold build rows
    are local (their probes co-shuffle to the same partition)."""
    if how not in ("inner", "semi", "left", "anti", "right", "full"):
        raise ValueError(f"unknown join type {how!r}")
    P, L = mesh.size, mesh.local
    outer_build = how in ("right", "full")

    dev = probe_keys[0].device
    with tracing.span("gt.join.hot_keys", device=dev):
        hot_keys, hot_valid = detect_hot_keys(probe_keys, probe_valid, mesh,
                                              num_hot)

        # ---- build side: split hot rows out, replicate them --------------
        b_hot, hot_sel, hot_ok, hot_overflow = [], [], [], []
        for i in range(L):
            nb = build_keys[i].shape[0]
            bh = _is_in_table(build_keys[i], hot_keys, hot_valid) \
                & build_valid[i]
            bidx, n_bhot, _ = compact_sort(bh)
            cap_h = min(hot_replicate_capacity, nb)
            b_hot.append(bh)
            hot_sel.append(bidx[:cap_h].long().clamp(max=max(nb - 1, 0)))
            hot_ok.append(torch.arange(cap_h, device=bh.device)
                          < torch.clamp(n_bhot, max=cap_h))
            hot_overflow.append(n_bhot > cap_h)
        cap_h = hot_sel[0].shape[0]
        rep_keys = mesh.all_gather([_take(build_keys[i], hot_sel[i])
                                    for i in range(L)])            # [P*cap_h]
        rep_ok = mesh.all_gather(hot_ok)
        rep_cols = {}
        for name, (v, vv) in build_cols.items():
            rep_cols[name] = (
                mesh.all_gather([_take(v[i], hot_sel[i]) for i in range(L)]),
                mesh.all_gather([hot_ok[i] if vv is None
                                 else vv[i].index_select(0, hot_sel[i])
                                 & hot_ok[i] for i in range(L)]))

        # ---- shuffle the cold remainder ----------------------------------
        part_p = [torch.where(_is_in_table(k, hot_keys, hot_valid),
                              mesh.index(i), partition_of(k, P, seed))
                  for i, k in enumerate(probe_keys)]
    pk, pvalid, pcols, ov1 = _shuffle_cols(
        probe_keys, probe_valid, probe_cols, mesh, probe_capacity,
        part_ids=part_p, seed=seed)
    bk, bvalid, bcols, ov2 = _shuffle_cols(
        build_keys, [v & ~h for v, h in zip(build_valid, b_hot)],
        build_cols, mesh, build_capacity,
        part_ids=[partition_of(k, P, seed) for k in build_keys], seed=seed)

    # ---- local join against shuffled-cold + replicated-hot build
    # (+ for right/full, the origin partition's own null-key rows) ---------
    base_how = {"right": "inner", "full": "left"}.get(how, how)
    parts = []
    for i in range(L):
        with tracing.span("gt.join.build", device=dev):
            blocks_k = [bk[i], rep_keys]
            blocks_ok = [bvalid[i], rep_ok]
            blocks_cols = {}
            for name in build_cols:
                v1, vv1 = bcols[name]
                v2, vv2 = rep_cols[name]
                blocks_cols[name] = ([v1[i], v2],
                                     [bvalid[i] if vv1 is None else vv1[i],
                                      vv2])
            key_valid = None
            if outer_build:
                nulls = ~build_valid[i]
                blocks_k.append(build_keys[i])
                blocks_ok.append(nulls)
                for name, (v, vv) in build_cols.items():
                    blocks_cols[name][0].append(v[i])
                    blocks_cols[name][1].append(nulls if vv is None
                                                else vv[i] & nulls)
                key_valid = torch.cat([torch.ones_like(bvalid[i]),
                                       torch.ones_like(rep_ok), ~nulls])
            all_bk = torch.cat([signed_view(b) for b in blocks_k]).view(
                build_keys[i].dtype)
            all_bvalid = torch.cat(blocks_ok)
            all_bcols = {name: (torch.cat([signed_view(x) for x in v]).view(
                v[0].dtype), torch.cat(vv))
                for name, (v, vv) in blocks_cols.items()}
        res = join(pk[i], all_bk, out_capacity, base_how,
                   probe_valid=None, build_valid=key_valid,
                   probe_exists=pvalid[i], build_exists=all_bvalid,
                   build_unique=build_unique)
        parts.append((res, all_bvalid, all_bcols))

    if outer_build:
        with tracing.span("gt.join.probe", device=dev):
            bhits = []
            for res, all_bvalid, _ in parts:
                nb_all = all_bvalid.shape[0]
                r = torch.arange(res.build_idx.shape[0],
                                 device=res.count.device)
                pair_ok = (r < res.count) & (res.build_idx >= 0)
                bi = torch.where(pair_ok, res.build_idx, nb_all).long()
                bhit = torch.zeros(nb_all + 1, dtype=torch.bool,
                                   device=bi.device)
                bhit[bi] = True
                bhits.append(bhit[:nb_all])
            # replicated block: hit flags combined over the mesh
            nb_local = [b.shape[0] for b in bk]
            rep_hit = mesh.pmax([b[n:n + P * cap_h]
                                 for b, n in zip(bhits, nb_local)])
            for i, (res, all_bvalid, all_bcols) in enumerate(parts):
                nb_all, nl = all_bvalid.shape[0], nb_local[i]
                dev = all_bvalid.device
                own = (torch.arange(P * cap_h, device=dev) // max(cap_h, 1)) \
                    == mesh.index(i)
                unmatched = torch.cat([
                    bvalid[i] & ~bhits[i][:nl],
                    rep_ok & ~rep_hit & own,
                    all_bvalid[nl + P * cap_h:]])              # null keys
                n_un = unmatched.sum(dtype=torch.int32)
                u32 = unmatched.to(torch.int32)
                upos = torch.cumsum(u32, 0, dtype=torch.int32) - u32
                total = res.count
                total2 = total + n_un
                C = out_capacity
                if C is None:                  # sized by the rows emitted
                    with tracing.sync("outer_total"):
                        C = int(total2)
                uslot = torch.where(unmatched & (total + upos < C),
                                    total + upos, C).long()
                pad = C + 1 - res.build_idx.shape[0]
                build_out = torch.cat([res.build_idx,
                                       res.build_idx.new_zeros(pad)])
                build_out[uslot] = torch.arange(nb_all, dtype=build_out.dtype,
                                                device=dev)
                probe_out = torch.cat([res.probe_idx,
                                       res.probe_idx.new_full((pad,), -1)])
                probe_out[uslot] = -1
                res = JoinResult(probe_out[:C], build_out[:C],
                                 total2.clamp(max=C).to(torch.int32),
                                 res.overflow | (total2 > C))
                parts[i] = (res, all_bvalid, all_bcols)

    results, outs, row_oks, overflows = [], [], [], []
    for i, (res, _, all_bcols) in enumerate(parts):
        cols, row_ok = gather_payload(
            res, probe_cols={**_pick(pcols, i),
                             "__probe_key": (pk[i], pvalid[i])},
            build_cols=all_bcols)
        results.append(res)
        outs.append(cols)
        row_oks.append(row_ok)
        overflows.append(ov1 | ov2 | res.overflow | hot_overflow[i])
    return results, _lists_of_pairs(outs), row_oks, overflows
