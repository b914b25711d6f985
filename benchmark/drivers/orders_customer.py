"""ORDERS ⋈ CUSTOMER: the configuration's query through the program's
pipeline (``parallel.run_pipeline_with_retry``) over the tables made on
the card, one query a request, :X drawn from the traffic's values in
rounds whose order is drawn from the seed.

Traffic parameters (``traffic/<name>.json``):
  thresholds_cents  the values of :X (o_totalprice > :X), in cents; each
                    round sends every value once;
  partitions        the mesh's partitions (``parallel.make_mesh``);
  warm_seconds      the closed loop's run before the window, in set-up;
  trace_seconds     the length of the traced slice.
Every answer of the window is kept and compared once it has closed.
"""
from __future__ import annotations

import numpy as np

from benchmark.data.orders_customer import MKTSEGMENTS, orders_customer
from benchmark.harness import compare
from benchmark.harness.loop import Request
from benchmark.reference import _plain
from benchmark.reference.orders_customer import plain

COUNTS = ("filter_out", "join_out", "agg_groups", "bytes_shuffled", "retries")


class Driver:
    def __init__(self, gt, config: dict, traffic: dict, seed: int, device,
                 rows: int = None):
        # ``rows`` (the tests): that many orders, four lines an order and
        # a customer a tenth of them
        orders = rows or config["orders"]
        lines = config["lines"] if rows is None else 4 * rows
        customers = (config["customers"] if rows is None
                     else max(rows // 10, 16))
        self.t = orders_customer(orders, lines, customers, seed, device)
        self.rows = orders
        self.thresholds = [int(x) for x in traffic["thresholds_cents"]]
        self.rng = np.random.default_rng(seed)
        self.mesh = gt.parallel.make_mesh(int(traffic["partitions"]),
                                          device=device)
        self.run = gt.parallel.run_pipeline_with_retry
        self.answers = []
        self.counts = {}
        self._order = self._rounds()

    def _rounds(self):
        while True:
            for k in self.rng.permutation(len(self.thresholds)):
                yield self.thresholds[k]

    def _query(self, x: int):
        t = self.t
        return self.run(self.mesh, t["o_custkey"], t["o_totalprice"],
                        t["c_custkey"], t["c_mktsegment"],
                        filter_threshold=x)

    def warm_shapes(self):
        """Every value of :X once, then once more."""
        for _ in range(2):
            for x in self.thresholds:
                self._query(x)

    def next_request(self) -> Request:
        x = next(self._order)
        return Request(f"X={x}", self.rows, lambda: self._query(x), key=x)

    def record(self, req: Request, result) -> None:
        keys, sums, counts, metrics = result
        self.answers.append((req.key, (keys, sums, counts,
                                       metrics["join_out"])))
        self.counts.setdefault(req.key, {k: metrics[k] for k in COUNTS})

    def forget(self) -> None:
        """Drop the answers kept so far (those of the warm-up)."""
        self.answers = []

    def release(self) -> None:
        """Free the program's state; only the answers stay."""
        self.mesh = self.run = self._order = None

    def control_answers(self):
        """The control in the program's place: the reference summing in
        float32, once for each value of :X."""
        for x in self.thresholds:
            yield x, plain(self.t, x, len(MKTSEGMENTS), _plain.FLOAT32)

    def check(self, answers=None) -> dict:
        """Every answer (or ``answers``) against the reference's for its
        :X."""
        want, out = {}, {"compared_answers": 0, "differing_answers": 0,
                         "sum_error": 0}
        for x, got in (self.answers if answers is None else answers):
            if x not in want:
                want[x] = plain(self.t, x, len(MKTSEGMENTS))
            d = compare.compare_groups(got, want[x])
            out["differing_answers"] += d["differing_answers"]
            out["sum_error"] = max(out["sum_error"], d["sum_error"])
            out["compared_answers"] += 1
        return out
