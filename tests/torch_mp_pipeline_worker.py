"""Worker for tests/test_torch_multiprocess_mesh.py and the NCCL case of
tests/test_torch_kernels_gpu.py.

Runs the port's configs[4] pipeline, a shuffle and a distributed sort over
a 4-partition mesh, either in one process holding all four partitions or
as one of ``world`` ``torch.distributed`` processes holding 4 / world each
(gloo on the CPU; NCCL with one card a process, ``cuda:<rank>``). Same
seeded inputs every way; rank 0 writes the results (the per-partition
outputs gathered in mesh order) to a JSON file. A process of a group joins
it with a finite timeout and leaves it as every rank does
(``parallel.join_group`` / ``leave_group``: a barrier, then the group
destroyed), so that no rank tears down its side while another still talks
to it.

Usage: python torch_mp_pipeline_worker.py <single|dist> <rank> <world>
       <port> <out> <cpu|cuda>
"""
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

mode, rank, world, port, out_path, kind = (
    sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
    sys.argv[5], sys.argv[6])
device = "cpu" if kind == "cpu" else f"cuda:{rank}"
if kind == "cuda":
    torch.cuda.set_device(rank)
from gandiva_tpu_torch.parallel import (build_filter_join_agg_sort,
                                        dist_sort, join_group, leave_group,
                                        make_mesh, run_pipeline, shard,
                                        shuffle_by_key, unshard)

if mode == "dist":
    join_group("gloo" if kind == "cpu" else "nccl", int(port), world, rank,
               120, device)

P = 4
mesh = make_mesh(P, device=device)
assert mesh.local == (P // world if mode == "dist" else P)

TOTAL, BTOTAL = 1024, 128
rng = np.random.default_rng(0)
orders_key = (rng.zipf(1.4, TOTAL) % (BTOTAL * 2)).astype(np.int64)
orders_amt = rng.integers(1, 100, TOTAL).astype(np.int64)
dim_key = rng.permutation(BTOTAL * 2)[:BTOTAL].astype(np.int64)
dim_seg = rng.integers(0, 5, BTOTAL).astype(np.int64)
valid = rng.random(TOTAL) < 0.9

fn = build_filter_join_agg_sort(mesh, num_groups=16, num_hot=8,
                                hot_capacity=64)
keys, sums, counts, metrics = run_pipeline(fn, orders_key, orders_amt,
                                           dim_key, dim_seg, mesh)

k, a, ok = (shard(mesh, x) for x in (orders_key, orders_amt, valid))
flat, fvalid, overflow = shuffle_by_key(k, ok, {"key": k, "amt": a}, mesh,
                                        TOTAL // P)
sk, svalid, snull, spay, sov = dist_sort(a, ok, {"k": (k, None)}, mesh,
                                         capacity=TOTAL // 2,
                                         nulls_first=False)
result = {
    "keys": keys.tolist(), "sums": sums.tolist(), "counts": counts.tolist(),
    "metrics": {m: metrics[m] for m in ("rows_in", "filter_out", "join_out",
                                        "agg_groups", "bytes_shuffled")},
    "shuffle": [unshard(mesh, x).tolist()
                for x in (flat["key"], flat["amt"], fvalid)],
    "shuffle_overflow": bool(overflow),
    "sort": [unshard(mesh, x).tolist()
             for x in (sk, svalid, snull, spay["k"][0])],
    "sort_overflow": bool(sov),
}
if rank == 0:
    with open(out_path, "w") as f:
        json.dump(result, f)
if mode == "dist":
    leave_group()
print(f"worker {mode}/{rank} of {world} on {device}: ok ({len(keys)} "
      "groups)", flush=True)
