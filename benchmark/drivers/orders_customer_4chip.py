"""ORDERS ⋈ CUSTOMER over P processes, one card each: the configuration's
query through the program's pipeline (``parallel.run_pipeline_with_retry``)
over ``make_mesh(P)``, each process holding only its own chunk of the
tables (``data/orders_customer_chunks.py``), made on its card from
(``--seed``, its rank). One query a request, :X drawn from the traffic's
values in rounds whose order is drawn from the seed.

This process is rank 0, on the harness's card (``cuda:0``); it starts
ranks 1 .. P-1 (``drivers/orders_customer_4chip_rank.py``) on
``cuda:1`` .. ``cuda:P-1`` and forms the group with them. Before each
request, outside the timed call, it sends the request's :X to every rank;
every rank then runs the same call. A worker that dies, or an exception of
this rank's call, ends the run non-zero; the workers end with this process.
``release`` and ``check`` end the workers: every rank checks its own copy
of every answer of the window against the plain reference, the ranks
summing the reference's partial groups over gloo.

Traffic parameters (``traffic/<name>.json``):
  thresholds_cents  the values of :X (o_totalprice > :X), in cents; each
                    round sends every value once;
  survival_shares   the share of the orders above each value, for the
                    per-layer metrics' byte counts;
  partitions        the mesh's partitions, one process and card each;
  warm_seconds      the closed loop's run before the window, in set-up;
  trace_seconds     the length of the traced slice.
"""
from __future__ import annotations

import atexit
import json
import os
import socket
import subprocess
import sys
import threading
import time
import traceback
from pathlib import Path

import numpy as np

from benchmark.drivers.orders_customer_4chip_rank import (
    CHECK, CONTROL, FORGET, QUERY, RELEASE, Rank)
from benchmark.harness.loop import Request

ROOT = Path(__file__).resolve().parents[2]
END_S = 120                 # the workers' exit after the check, at most


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class Driver:
    def __init__(self, gt, config: dict, traffic: dict, seed: int, device,
                 rows: int = None):
        if not hasattr(gt.parallel, "held"):
            raise RuntimeError("this program's pipeline takes no partitions "
                               "of a process's own, which this cell needs")
        world = int(traffic["partitions"])
        self.thresholds = [int(x) for x in traffic["thresholds_cents"]]
        self.shares = dict(zip(self.thresholds,
                               traffic["survival_shares"]))
        on_card = device.type == "cuda"
        if on_card:
            import torch

            from gandiva_tpu_torch.ops.kernels import build

            build.build_all()           # once, before the workers load them
            device = torch.device("cuda", 0)
        port = _free_port()
        spec = {"config": config, "thresholds": self.thresholds,
                "seed": seed, "world": world, "port": port, "rows": rows}
        self.ending = self.stopped = False
        self.workers = [subprocess.Popen(
            [sys.executable, "-m",
             "benchmark.drivers.orders_customer_4chip_rank",
             json.dumps({**spec, "rank": r,
                         "device": f"cuda:{r}" if on_card else "cpu"})],
            cwd=ROOT, stdout=sys.stderr) for r in range(1, world)]
        atexit.register(self._end_workers)
        threading.Thread(target=self._watch, daemon=True).start()
        self.me = Rank(gt, config, self.thresholds, seed, 0, world, port,
                       device, rows)
        self.rows = self.me.size["orders"]
        self.rng = np.random.default_rng(seed)
        self._order = self._rounds()

    # ---- the workers ---------------------------------------------------
    def _watch(self) -> None:
        """End this process non-zero as soon as a worker ends before the
        check has let it, or ends non-zero (this rank then waits in a
        collective that the worker will not join)."""
        while not self.stopped:
            for p in self.workers:
                rc = p.poll()
                if rc is not None and not self.stopped and (
                        rc != 0 or not self.ending):
                    print(f"rank of pid {p.pid} ended with {rc}",
                          file=sys.stderr, flush=True)
                    self._end_workers()
                    os._exit(5)
            time.sleep(0.2)

    def _end_workers(self) -> None:
        self.stopped = True
        for p in self.workers:
            if p.poll() is None:
                p.kill()

    def _fail(self):
        """This rank's call raised: the other ranks wait in a collective
        that it will not join, so the run ends here, non-zero."""
        traceback.print_exc(file=sys.stderr)
        sys.stderr.flush()
        self._end_workers()
        if self.me.device.type == "cpu":
            # a process that runs more cells (the tests) needs its group
            # gone; on a card the process ends here
            import torch.distributed as dist

            dist.destroy_process_group()
        raise SystemExit(5)

    # ---- the harness's calls -------------------------------------------
    def _rounds(self):
        while True:
            for k in self.rng.permutation(len(self.thresholds)):
                yield self.thresholds[k]

    def _query(self, x: int):
        try:
            return self.me.query(x)
        except BaseException:
            self._fail()

    def _send(self, op: int, x: int = 0) -> None:
        self.me.send(op, x)

    def warm_shapes(self):
        """Every value of :X once, then once more."""
        for _ in range(2):
            for x in self.thresholds:
                self._send(QUERY, x)
                self._query(x)

    def next_request(self) -> Request:
        x = next(self._order)
        self._send(QUERY, x)
        return Request(f"X={x}", self.rows, lambda: self._query(x), key=x,
                       survivors=round(self.shares[x] * self.rows),
                       facts={"partitions": len(self.workers) + 1})

    def record(self, req: Request, result) -> None:
        self.me.record(req.key, result)

    @property
    def counts(self) -> dict:
        return self.me.counts

    def forget(self) -> None:
        """Drop the answers kept so far (those of the warm-up), on every
        rank."""
        self._send(FORGET)
        self.me.forget()

    def release(self) -> None:
        """Free the program's state on every rank; only the answers
        stay."""
        self._send(RELEASE)
        self.me.release()
        self._order = None

    def control_answers(self):
        """The control in the program's place: every rank's reference
        summing in float32, once for each value of :X."""
        return CONTROL

    def check(self, answers=None) -> dict:
        """Every rank's answers (or, given ``control_answers()``, the
        control's) against the reference's for their :X, summed over the
        ranks; then the workers end."""
        control = answers == CONTROL
        self.ending = True
        self._send(CONTROL if control else CHECK)
        found = self.me.check(control=control)
        self.me.counts["memory_peak_bytes_by_rank"] = found.pop("peaks")
        import gandiva_tpu_torch as gt

        gt.parallel.leave_group()
        for p in self.workers:
            if p.wait(timeout=END_S) != 0:
                raise RuntimeError(f"a rank ended with {p.returncode}")
        self.stopped = True
        if found.pop("forbidden_modules"):
            raise RuntimeError("a rank loaded JAX or the JAX package")
        return found
