"""Multi-operator distributed pipeline (BASELINE configs[4]; from
gandiva_tpu.parallel.pipeline).

Composes the engine end to end the way Dremio composes Gandiva kernels into
fragment pipelines (SURVEY.md §3.5): per partition — filter → skew-aware
hash join → hash aggregate → global sort of the (small) group results. The
reference runs it as one ``shard_map``-ed jit program; the port runs the
same steps eagerly over the mesh's held partitions, each operator a loop
over them with the collectives between (``mesh.py``).

Per-operator observability (SURVEY.md §5.5): the step returns a metrics
dict (rows in/out per operator, bytes shuffled) beside the results — the
engine's rows/s accounting surface.
"""
from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from .. import tracing
from ..device import DEFAULT_DEVICE
from .mesh import Mesh, make_mesh, shard
from .ops import dist_hash_aggregate, dist_join_skewed

# data-sheet rates of the H100 SXM (not measurements): HBM3, and NVLink 4
# in one direction
H100_HBM_BYTES_PER_S = 3.35e12
H100_NVLINK_BYTES_PER_S = 4.5e11

_PIPELINE_CACHE: Dict[tuple, object] = {}


def build_filter_join_agg_sort(mesh: Mesh, nper: int, build_per: int,
                               num_groups: int = 64,
                               filter_threshold: int = 50,
                               shuffle_factor: int = 3,
                               out_factor: int = 4,
                               num_hot: int = 64,
                               hot_capacity: int = 2048):
    """The canonical pipeline over ``mesh``, memoized on (mesh, every shape
    and config parameter) as the reference memoizes its jit.

    Query shape (TPC-H-flavored):
        SELECT g.seg, SUM(o.amt), COUNT(*)
        FROM orders o JOIN dim g ON o.key = g.key
        WHERE o.amt > threshold
        GROUP BY g.seg ORDER BY g.seg

    Inputs per partition: orders (key, amt) of nper rows, dim (key, seg)
    of build_per rows. Returns fn(ok, oa, dk, ds), each a list with one
    tensor per held partition (``mesh.shard``), → (seg_sorted, sums,
    counts, n_groups, overflow, metrics): the first four and ``overflow``
    the same on every partition, ``metrics`` per-partition lists."""
    cache_key = (mesh, nper, build_per, num_groups, filter_threshold,
                 shuffle_factor, out_factor, num_hot, hot_capacity)
    fn = _PIPELINE_CACHE.get(cache_key)
    if fn is None:
        fn = _build_filter_join_agg_sort(*cache_key)
        _PIPELINE_CACHE[cache_key] = fn
    return fn


def _build_filter_join_agg_sort(mesh: Mesh, nper: int, build_per: int,
                                num_groups: int, filter_threshold: int,
                                shuffle_factor: int, out_factor: int,
                                num_hot: int, hot_capacity: int):
    probe_cap = shuffle_factor * nper
    out_cap = out_factor * nper
    build_cap = max(128, shuffle_factor * build_per)
    G = num_groups

    def fn(ok_, oa, dk, ds):
        L = mesh.local
        dev = oa[0].device
        # 1. filter (padding-free inputs here)
        with tracing.span("gt.filter", device=dev):
            keep = [a > filter_threshold for a in oa]
            n_keep = [k.sum(dtype=torch.int64) for k in keep]

        # 2. skew-aware join orders ⋈ dim
        _, cols, row_ok, ov_join = dist_join_skewed(
            ok_, keep, {"amt": (oa, None)},
            dk, [torch.ones_like(k, dtype=torch.bool) for k in dk],
            {"seg": (ds, None)}, mesh, probe_capacity=probe_cap,
            build_capacity=build_cap, out_capacity=out_cap, how="inner",
            num_hot=num_hot,
            hot_replicate_capacity=min(hot_capacity, dk[0].shape[0]))
        amt, amt_ok = cols["amt"]
        seg, seg_ok = cols["seg"]
        joined_ok = [row_ok[i] & amt_ok[i] & seg_ok[i] for i in range(L)]
        join_out = [j.sum(dtype=torch.int64) for j in joined_ok]

        # 3. aggregate by seg (second shuffle: co-locate groups)
        with tracing.span("gt.aggregate", device=dev):
            agg = dist_hash_aggregate(
                seg, joined_ok, {"amt": (amt, None)},
                [("amt", "sum"), ("amt", "count")], mesh, capacity=out_cap,
                max_groups=G)
        overflow = mesh.pmax([ov_join[i] | agg["overflow"][i]
                              for i in range(L)])

        # bytes shuffled (SURVEY.md §5.5), an UPPER BOUND as the
        # reference's: every surviving probe row through the join exchange
        # (key i64 + amt, one validity byte) and every joined row through
        # the aggregate exchange (seg i64 + amt, one validity byte). Hot
        # probe rows and rows hashed to their own partition move less.
        row_bytes_join = 8 + oa[0].element_size() + 1
        row_bytes_agg = 8 + amt[0].element_size() + 1
        rows_in = []
        for a in oa:
            with tracing.sync("rows_in"):  # a host-to-device copy waits
                rows_in.append(torch.tensor(a.shape[0], dtype=torch.int64,
                                            device=dev))
        metrics = {
            "rows_in": rows_in,
            "filter_out": n_keep,
            "join_out": join_out,
            "agg_groups": [c.to(torch.int64) for c in agg["group_count"]],
            "bytes_shuffled": [n_keep[i] * row_bytes_join
                               + join_out[i] * row_bytes_agg
                               for i in range(L)],
        }

        # 4. global sort of the group rows (tiny): gather every
        # partition's groups, present rows first, then by key
        with tracing.span("gt.sort", device=dev):
            present = [torch.arange(G, device=dev) < c
                       for c in agg["group_count"]]
            all_keys = mesh.all_gather([k[:G] for k in agg["keys"]])
            all_sum = mesh.all_gather([s[:G] for s in agg["agg:amt:sum"]])
            all_count = mesh.all_gather([c[:G]
                                         for c in agg["agg:amt:count"]])
            all_present = mesh.all_gather(present)
            order = torch.sort(all_keys, stable=True).indices
            order = order[torch.sort((~all_present[order]).to(torch.uint8),
                                     stable=True).indices]
            n_groups = all_present.sum(dtype=torch.int32)
            return (all_keys[order], all_sum[order], all_count[order],
                    n_groups, overflow, metrics)

    return fn


class PipelineOverflowError(RuntimeError):
    """Capacity overflow surfaced from a fixed-capacity exchange — the
    Status-style contract (SURVEY.md §5.3): device code never resizes; it
    flags, and the host retries with doubled capacity."""


def run_pipeline(fn, orders_key, orders_amt, dim_key, dim_seg, mesh: Mesh):
    """The host side: shard the inputs (numpy arrays or tensors) onto the
    mesh, run, unpack results and metrics.

    Metrics (SURVEY.md §5.5): per-operator row counts and bytes_shuffled
    summed over the mesh, and wall_time_s and rows_per_s of the whole step,
    from a synchronized start to the host's read of the group count (the
    join's data-dependent decisions sync the host inside it too)."""
    args = [shard(mesh, x) for x in (orders_key, orders_amt, dim_key,
                                     dim_seg)]
    if mesh.device.type == "cuda":
        with tracing.sync("synchronize"):
            torch.cuda.synchronize(mesh.device)
    t0 = time.perf_counter()
    skeys, ssum, scount, n_groups, overflow, metrics = fn(*args)
    with tracing.sync("n_groups"):
        ng = int(n_groups)                     # the host's read: a sync
    wall = time.perf_counter() - t0
    with tracing.sync("overflow"):
        overflowed = bool(overflow)
    if overflowed:
        raise PipelineOverflowError(
            "pipeline capacity overflow — rerun with larger "
            "shuffle_factor/out_factor")
    with tracing.sync("metrics"):
        totals = mesh.psum([torch.stack([metrics[k][i] for k in metrics])
                            for i in range(mesh.local)]).tolist()
    host_metrics = dict(zip(metrics, totals))
    host_metrics["wall_time_s"] = wall
    host_metrics["rows_per_s"] = host_metrics["rows_in"] / max(wall, 1e-9)
    results = []
    for t in (skeys, ssum, scount):
        with tracing.sync("results"):
            results.append(t[:ng].cpu().numpy())
    return (*results, host_metrics)


def run_pipeline_with_retry(mesh: Mesh, orders_key, orders_amt, dim_key,
                            dim_seg, num_groups: int = 64,
                            filter_threshold: int = 50,
                            shuffle_factor: int = 3, out_factor: int = 4,
                            max_retries: int = 3, **kw):
    """Overflow → retry loop (SURVEY.md §7 hard part #1): run the
    pipeline; on a capacity-overflow flag, double both capacity factors
    and run again (the retry is a HOST decision; the exchanges stay
    fixed-capacity)."""
    with tracing.span("gt.pipeline"):
        nper = int(orders_key.shape[0]) // mesh.size
        build_per = int(dim_key.shape[0]) // mesh.size
        sf, of = shuffle_factor, out_factor
        last: Optional[PipelineOverflowError] = None
        for attempt in range(max_retries + 1):
            fn = build_filter_join_agg_sort(
                mesh, nper, build_per, num_groups=num_groups,
                filter_threshold=filter_threshold, shuffle_factor=sf,
                out_factor=of, **kw)
            try:
                with tracing.span("gt.pipeline.attempt", device=mesh.device):
                    keys, sums, counts, metrics = run_pipeline(
                        fn, orders_key, orders_amt, dim_key, dim_seg, mesh)
                tracing.add("retries", attempt)
                metrics["retries"] = attempt
                metrics["shuffle_factor"] = sf
                metrics["out_factor"] = of
                return keys, sums, counts, metrics
            except PipelineOverflowError as e:
                last = e
                sf, of = sf * 2, of * 2
        raise last


def _scaling_inputs(rng, total: int, total_build: int, num_groups: int):
    """The harnesses' tables, from numpy: Zipf(1.4) order keys over twice
    the dim's key range, amounts in [1, 100), unique dim keys, segments."""
    orders_key = (rng.zipf(1.4, total) % (total_build * 2)).astype(np.int64)
    orders_amt = rng.integers(1, 100, total).astype(np.int64)
    dim_key = rng.permutation(total_build * 2)[:total_build].astype(np.int64)
    dim_seg = rng.integers(0, num_groups, total_build).astype(np.int64)
    return orders_key, orders_amt, dim_key, dim_seg


def _best_wall(mesh, fn, inputs, repeats: int) -> float:
    """One warm run, then the best of ``repeats`` walls."""
    run_pipeline(fn, *inputs, mesh)
    return min(run_pipeline(fn, *inputs, mesh)[3]["wall_time_s"]
               for _ in range(repeats))


def measure_scaling_efficiency(partition_counts, total_rows: int,
                               total_build: int, num_groups: int = 16,
                               seed: int = 0, repeats: int = 3,
                               device=DEFAULT_DEVICE, **kw):
    """configs[4] strong-scaling harness: the SAME tables (``total_rows``
    orders × ``total_build`` dim rows, fixed seed) run over meshes of each
    size in ``partition_counts``; per size one warm run, then the best of
    ``repeats`` walls. efficiency(n) = T(n0)·n0 / (n·T(n)) against the
    smallest count n0 — 1.0 is linear scaling.

    Returns rows {"n_partitions", "n_cards", "baseline_partitions",
    "wall_s", "rows_per_s", "efficiency"}. Partitions of one card share
    its memory and compute, so they measure no scaling efficiency: that
    needs a mesh over as many cards as partitions."""
    counts = sorted(set(int(n) for n in partition_counts))
    if total_rows % counts[-1] or total_build % counts[-1]:
        raise ValueError("total work must divide every mesh size")
    inputs = _scaling_inputs(np.random.default_rng(seed), total_rows,
                             total_build, num_groups)
    results, wall_0 = [], None
    for n in counts:
        mesh = make_mesh(n, device=device)
        fn = build_filter_join_agg_sort(mesh, total_rows // n,
                                        total_build // n,
                                        num_groups=num_groups, **kw)
        best = _best_wall(mesh, fn, inputs, repeats)
        if wall_0 is None:
            wall_0 = best * counts[0]
        results.append({"n_partitions": n, "n_cards": mesh.num_cards,
                        "baseline_partitions": counts[0], "wall_s": best,
                        "rows_per_s": total_rows / best,
                        "efficiency": wall_0 / (n * best)})
    return results


def measure_weak_scaling(partition_counts, rows_per_shard: int,
                         build_per_shard: int, num_groups: int = 16,
                         seed: int = 0, repeats: int = 3,
                         device=DEFAULT_DEVICE, **kw):
    """Weak-scaling harness: per-partition work is FIXED, so a perfectly
    scaling system keeps walls flat as partitions (on as many cards) are
    added. efficiency(n) = T(n0) / T(n) against the SMALLEST count n0,
    which every row names as ``baseline_partitions`` (it is T(1) only when
    the counts start at 1).

    Returns rows {"n_partitions", "n_cards", "baseline_partitions",
    "wall_s", "rows_per_s", "efficiency"}."""
    counts = sorted(set(int(n) for n in partition_counts))
    rng = np.random.default_rng(seed)
    results, wall_0 = [], None
    for n in counts:
        total = rows_per_shard * n
        inputs = _scaling_inputs(rng, total, build_per_shard * n,
                                 num_groups)
        mesh = make_mesh(n, device=device)
        fn = build_filter_join_agg_sort(mesh, rows_per_shard,
                                        build_per_shard,
                                        num_groups=num_groups, **kw)
        best = _best_wall(mesh, fn, inputs, repeats)
        if wall_0 is None:
            wall_0 = best
        results.append({"n_partitions": n, "n_cards": mesh.num_cards,
                        "baseline_partitions": counts[0], "wall_s": best,
                        "rows_per_s": total / best,
                        "efficiency": wall_0 / best})
    return results


def model_ici_efficiency(metrics: Dict, n_partitions: int,
                         link_bytes_per_s: float = H100_NVLINK_BYTES_PER_S,
                         hbm_bytes_per_s: float = H100_HBM_BYTES_PER_S):
    """Project the scaling efficiency of ``n_partitions`` cards from one
    run's ``run_pipeline`` metrics (the counterpart of the reference's ICI
    model; the name is kept).

    Per card and per step:
      t_compute ≈ essential memory bytes / ``hbm_bytes_per_s`` — 16 B a row
        through each operator pass, 16·(rows_in + filter_out +
        2·join_out) / n;
      t_compute_measured = the run's own time per row (wall_time_s /
        rows_in) times the rows a card holds (rows_in / n);
      t_comm ≈ bytes_shuffled / n · (n-1)/n / ``link_bytes_per_s`` — an
        all-to-all keeps 1/n of the bytes on the card.
    Overlapped efficiency is t_compute / max(t_compute, t_comm), the
    serialized floor t_compute / (t_compute + t_comm). The default rates
    are the H100 SXM's data-sheet figures (HBM3 3.35 TB/s, NVLink 4 450
    GB/s a direction), stated, not measured."""
    n = max(1, n_partitions)
    hbm_bytes = 16.0 * (metrics["rows_in"] + metrics["filter_out"]
                        + 2 * metrics["join_out"]) / n
    comm_bytes = metrics["bytes_shuffled"] / n * (n - 1) / n
    t_comp = hbm_bytes / hbm_bytes_per_s
    t_comm = comm_bytes / link_bytes_per_s
    s_per_row = metrics["wall_time_s"] / max(metrics["rows_in"], 1)
    t_comp_meas = metrics["rows_in"] / n * s_per_row

    def ratio(a, b):
        return a / b if b > 0 else 1.0

    return {
        "hbm_bytes_per_shard": hbm_bytes,
        "link_bytes_per_shard": comm_bytes,
        "t_compute_s": t_comp,
        "t_comm_s": t_comm,
        "t_compute_measured_s": t_comp_meas,
        "efficiency_overlapped": ratio(t_comp, max(t_comp, t_comm)),
        "efficiency_serialized": ratio(t_comp, t_comp + t_comm),
        "efficiency_measured": ratio(t_comp_meas, max(t_comp_meas, t_comm)),
    }
