"""Worker for tests/test_torch_own_partitions.py and the NCCL case of
tests/test_torch_kernels_gpu.py: one of ``world`` ``torch.distributed``
processes (gloo on the CPU; NCCL with one card a process, ``cuda:<rank>``)
dividing a 4-partition mesh. Each process makes only its own partitions
of a small ORDERS ⋈ CUSTOMER (the benchmark's chunk generator, chunk k
for partition k, on its own device) and runs the pipeline's
own-partition entry point over them for a few values of :X. Rank 0 then
gathers every process's orders in plain ``torch.distributed`` calls, runs
the plain reference over the whole tables, and writes both answers to a
JSON file. Every rank ends with ``parallel.leave_group``; an exception
ends the process with exit code 1.

Usage: python torch_mp_own_partitions_worker.py <rank> <world> <port>
       <out> <cpu|cuda> <orders> <run|raise>
("raise": rank 1 raises once the group is formed).
"""
import json
import os
import sys
import traceback

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch
import torch.distributed as dist

SEED = 2**31 + 19
PARTITIONS = 4
XS = (12_000_000, 14_000_000, 17_000_000)
TIMEOUT_S = 40


def chunks(mesh, orders: int, device) -> dict:
    """This process's partitions: chunk k of the tables for partition k."""
    from benchmark.data.orders_customer_chunks import orders_customer_chunk

    made = [orders_customer_chunk(1, orders, 4 * orders, orders // 10,
                                  PARTITIONS, mesh.index(j), SEED, device)
            for j in range(mesh.local)]
    return {k: [c[k] for c in made] for k in ("o_custkey", "o_totalprice",
                                              "c_custkey", "c_mktsegment")}


def answer(result) -> list:
    keys, sums, counts, metrics = result
    return [keys.tolist(), sums.tolist(), counts.tolist(),
            int(metrics["join_out"])]


def main(rank, world, port, out, kind, orders, mode) -> None:
    from benchmark.data.orders_customer_chunks import segments
    from benchmark.reference.orders_customer import plain
    from gandiva_tpu_torch import parallel

    device = "cpu" if kind == "cpu" else f"cuda:{rank}"
    if kind == "cuda":
        torch.cuda.set_device(rank)
    parallel.join_group("gloo" if kind == "cpu" else "nccl", port, world,
                        rank, TIMEOUT_S, device)
    if mode == "raise" and rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    mesh = parallel.make_mesh(PARTITIONS, device=device)
    t = chunks(mesh, orders, device)
    got = {x: answer(parallel.run_pipeline_with_retry(
        mesh, t["o_custkey"], t["o_totalprice"], t["c_custkey"],
        t["c_mktsegment"], num_groups=8, filter_threshold=x)) for x in XS}
    # the reference over the whole tables, gathered outside the mesh
    whole = {}
    for name in ("o_custkey", "o_totalprice"):
        mine = torch.cat(t[name])
        parts = [torch.empty_like(mine) for _ in range(world)]
        dist.all_gather(parts, mine)
        whole[name] = torch.cat(parts)
    if rank == 0:
        customers = orders // 10
        whole["c_custkey"] = torch.arange(1, customers + 1, device=device)
        whole["c_mktsegment"] = segments(customers, SEED, device)
        want = {}
        for x in XS:
            codes, sums, counts, joined = plain(whole, x, 5)
            want[x] = [codes.tolist(), sums.tolist(), counts.tolist(),
                       joined]
        with open(out, "w") as f:
            json.dump({"answers": got, "reference": want}, f)
    parallel.leave_group()
    print(f"rank {rank} of {world} on {device}: ok", flush=True)


if __name__ == "__main__":
    try:
        a = sys.argv[1:]
        main(int(a[0]), int(a[1]), int(a[2]), a[3], a[4], int(a[5]), a[6])
    except BaseException:
        traceback.print_exc(file=sys.stderr)
        sys.stderr.flush()
        os._exit(1)
