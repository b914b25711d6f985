"""One rank of ``orders_customer_4chip``: a process that holds one chunk of
ORDERS and CUSTOMER on its own card (``data/orders_customer_chunks.py``),
one partition of a ``make_mesh(P)`` over P such processes, and runs every
query that rank 0 sends it through the program's pipeline
(``parallel.run_pipeline_with_retry`` over its own partition).

Rank 0 is the harness's process (``drivers/orders_customer_4chip.py``);
ranks 1 .. P-1 run this module:

    python3 -m benchmark.drivers.orders_customer_4chip_rank '<json>'

from the root of a checkout, the JSON holding the configuration, the
traffic, the seed, the rank, the world, the port and the device. The
processes form one group (NCCL on the cards, gloo on the CPU) for the
program's collectives, and a gloo group beside it on which rank 0 sends
each command (a query's :X, or the end of the warm-up, the window or the
run) before the timed call. A worker ends with rank 0: it asks the kernel
for a signal at its parent's death and watches its parent besides; an
exception ends it non-zero, which rank 0 watches for.
"""
from __future__ import annotations

import ctypes
import datetime
import json
import os
import signal
import sys
import threading
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from benchmark.data.orders_customer import MKTSEGMENTS
from benchmark.data.orders_customer_chunks import (orders_customer_chunk,
                                                   segments)
from benchmark.harness import compare, guard
from benchmark.reference import _plain
from benchmark.reference.orders_customer import plain

QUERY, FORGET, RELEASE, CHECK, CONTROL = range(5)
COLLECTIVE_TIMEOUT_S = 300      # a rank waiting on one that died raises
CONTROL_TIMEOUT_S = 1800        # rank 0 between two commands, at most
COUNTS = ("filter_out", "join_out", "agg_groups", "bytes_shuffled",
          "retries")


def sizes(config: dict, rows=None) -> dict:
    """The tables' sizes: the configuration's, or (``rows``, the tests)
    that many orders, four lines an order and a customer a tenth of
    them, each a multiple of the partitions."""
    p = int(config["partitions"])
    if rows is None:
        return {k: int(config[k]) for k in ("orders", "lines", "customers")}
    orders = rows // p * p
    return {"orders": orders, "lines": 4 * orders,
            "customers": max(rows // 10 // p, 16) * p}


class Rank:
    """This process's part: its group, its chunk, its mesh and answers."""

    def __init__(self, gt, config: dict, thresholds: list, seed: int,
                 rank: int, world: int, port: int, device, rows=None):
        self.device = device = torch.device(device)
        on_card = device.type == "cuda"
        if on_card:
            torch.cuda.set_device(device)
        gt.parallel.join_group("nccl" if on_card else "gloo", port, world,
                               rank, COLLECTIVE_TIMEOUT_S, device)
        self.control = dist.new_group(backend="gloo", timeout=(
            datetime.timedelta(seconds=CONTROL_TIMEOUT_S)))
        self.rank, self.world, self.seed = rank, world, seed
        self.thresholds = [int(x) for x in thresholds]
        self.size = sizes(config, rows)
        self.sf = int(config["scale_factor"])
        self.t = orders_customer_chunk(
            self.sf, self.size["orders"], self.size["lines"],
            self.size["customers"], world, rank, seed, device)
        self.mesh = gt.parallel.make_mesh(world, device=device)
        self.run = gt.parallel.run_pipeline_with_retry
        self.answers, self.counts, self.peak = [], {}, 0

    # ---- commands ------------------------------------------------------
    def send(self, op: int, x: int = 0) -> None:
        """Rank 0: send a command to every rank."""
        dist.broadcast(torch.tensor([op, x], dtype=torch.int64), 0,
                       group=self.control)

    def receive(self) -> tuple:
        cmd = torch.zeros(2, dtype=torch.int64)
        dist.broadcast(cmd, 0, group=self.control)
        return tuple(cmd.tolist())

    def serve(self) -> None:
        """A worker: answer rank 0's commands until the check."""
        while True:
            op, x = self.receive()
            if op == QUERY:
                self.record(x, self.query(x))
            elif op == FORGET:
                self.forget()
            elif op == RELEASE:
                self.release()
            else:
                self.check(control=op == CONTROL)
                return

    # ---- the program ---------------------------------------------------
    def query(self, x: int):
        t = self.t
        return self.run(self.mesh, [t["o_custkey"]], [t["o_totalprice"]],
                        [t["c_custkey"]], [t["c_mktsegment"]],
                        filter_threshold=x)

    def record(self, x: int, result) -> None:
        keys, sums, counts, metrics = result
        self.answers.append((x, (keys, sums, counts, metrics["join_out"])))
        self.counts.setdefault(x, {k: metrics[k] for k in COUNTS})

    def forget(self) -> None:
        """The warm-up is over: drop its answers, and start the card's
        peak afresh, as the harness does on rank 0."""
        self.answers = []
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)

    def release(self) -> None:
        """The window is over: read the card's peak, and free the
        program's state; only the answers and the chunk stay."""
        if self.device.type == "cuda":
            self.peak = torch.cuda.max_memory_allocated(self.device)
        self.mesh = self.run = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ---- the check -----------------------------------------------------
    def _total(self, x: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
        dist.all_reduce(x, op=op, group=self.control)
        return x

    def reference(self, x: int, money: str = _plain.EXACT) -> tuple:
        """The plain query for :X over all the chunks: each rank runs it on
        its own ORDERS against the whole CUSTOMER, and the ranks sum their
        groups' sums and counts (in plain torch over the gloo group, not
        through the program's mesh)."""
        t = self.t
        whole = {"o_custkey": t["o_custkey"],
                 "o_totalprice": t["o_totalprice"],
                 "c_custkey": torch.arange(1, self.size["customers"] + 1,
                                           device=self.device),
                 "c_mktsegment": segments(self.size["customers"], self.seed,
                                          self.device)}
        groups = len(MKTSEGMENTS)
        codes, sums, counts, joined = plain(whole, x, groups, money)
        part = torch.zeros(2, groups + 1, dtype=torch.int64)
        part[0, torch.from_numpy(codes)] = torch.from_numpy(sums)
        part[1, torch.from_numpy(codes)] = torch.from_numpy(counts)
        part[1, groups] = joined
        part = self._total(part)
        present = part[1, :groups] > 0
        return (np.arange(groups)[present.numpy()],
                part[0, :groups][present].numpy(),
                part[1, :groups][present].numpy(), int(part[1, groups]))

    def check(self, control: bool = False) -> dict:
        """Every answer of this rank against the reference's for its :X
        (``control``: the reference in float32 in the program's place,
        once for each :X), summed over the ranks: answers compared and
        differing, the largest sum error; every rank's peak; and the
        modules of JAX or of the JAX package loaded in any rank."""
        if control:
            answers = [(x, self.reference(x, _plain.FLOAT32))
                       for x in self.thresholds]
        else:
            answers = self.answers
        want = {x: self.reference(x) for x in sorted({x for x, _ in
                                                      answers})}
        found = torch.zeros(3, dtype=torch.int64)
        for x, got in answers:
            d = compare.compare_groups(got, want[x])
            found[0] += 1
            found[1] += d["differing_answers"]
            found[2] = max(int(found[2]), d["sum_error"])
        err = self._total(found[2:].clone(), dist.ReduceOp.MAX)
        found = self._total(found[:2].clone())
        peaks = torch.zeros(self.world, dtype=torch.int64)
        peaks[self.rank] = self.peak
        forbidden = torch.tensor([len(guard.forbidden_modules())])
        return {"compared_answers": int(found[0]),
                "differing_answers": int(found[1]),
                "sum_error": int(err[0]),
                "peaks": self._total(peaks).tolist(),
                "forbidden_modules": int(self._total(forbidden))}


def _watch_parent() -> None:
    """End this process when its parent dies: the kernel's signal at the
    parent's death, and a thread that sees the parent change, for the
    case where the signal is not there."""
    parent = os.getppid()
    try:
        ctypes.CDLL(None, use_errno=True).prctl(1, signal.SIGKILL)  # PDEATHSIG
    except (OSError, AttributeError):
        pass
    if os.getppid() != parent:
        os._exit(3)

    def watch():
        while True:
            time.sleep(0.5)
            if os.getppid() != parent:
                os._exit(3)

    threading.Thread(target=watch, daemon=True).start()


def main(spec: dict) -> None:
    _watch_parent()
    try:
        import gandiva_tpu_torch as gt

        Rank(gt, spec["config"], spec["thresholds"], spec["seed"],
             spec["rank"], spec["world"], spec["port"], spec["device"],
             spec.get("rows")).serve()
        gt.parallel.leave_group()
    except BaseException:
        traceback.print_exc(file=sys.stderr)
        sys.stderr.flush()
        os._exit(1)


if __name__ == "__main__":
    main(json.loads(sys.argv[1]))
