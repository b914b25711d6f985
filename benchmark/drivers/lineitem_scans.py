"""LINEITEM scans: the configuration's queries as FilterProject plans over
the whole table made on the card, in rounds whose order is drawn from the
seed; each request is one ``evaluate_device`` over the table.

Traffic parameters (``traffic/<name>.json``):
  warm_seconds      the closed loop's run before the window, in set-up;
  trace_seconds     the length of the traced slice.
One answer of each query, drawn from the seed (a reservoir), is kept and
compared once the window has closed.
"""
from __future__ import annotations

import importlib

import numpy as np
import pyarrow as pa
import torch

from benchmark.data.lineitem import DICTIONARIES, DATE_COLUMNS, \
    KEY_COLUMNS, MONEY_COLUMNS, lineitem
from benchmark.harness import compare, plans
from benchmark.harness.loop import Request
from benchmark.reference import _plain


class Driver:
    def __init__(self, gt, config: dict, traffic: dict, seed: int, device,
                 rows: int = None):
        self.queries = list(config["queries"])
        self.n = rows or config["rows"]
        # ``rows`` (the tests) keeps four lines an order and a pool of 64
        # bytes a line
        orders = config["orders"] if rows is None else max(rows // 4, 1)
        pool = config["text_pool_bytes"] if rows is None else 64 * rows
        self.cols = lineitem(self.n, orders, seed, device, pool)
        self.rng = np.random.default_rng(seed)
        self.forget()
        self.plans, self.facts, self.types = {}, {}, {}
        for q in self.queries:
            schema, cond, exprs = importlib.import_module(
                f"benchmark.queries.{q}").build(gt)
            self.plans[q] = gt.make_filter_project(schema, cond, exprs,
                                                   device=device)
            self.facts[q] = plans.facts(cond, exprs)
            self.types[q] = {e.result_field.name: str(e.result_field.dtype)
                             for e in exprs}
        self.batch = self._batch(gt, device)
        self._order = self._rounds()

    def _batch(self, gt, device):
        """The table as the program holds it: each column wrapped as it
        was made, a string as codes into its dictionary."""
        codes, offsets, data = self.cols.pop("l_comment")
        comments = pa.Array.from_buffers(
            pa.string(), len(offsets) - 1,
            [None, pa.py_buffer(offsets), pa.py_buffer(data)])
        valid = torch.ones(self.n, dtype=torch.bool, device=device)
        dt, cols = gt.dtypes, {}
        for name in KEY_COLUMNS:
            cols[name] = gt.Column(self.cols[name], valid, dt.int64)
        cols["l_linenumber"] = gt.Column(self.cols["l_linenumber"], valid,
                                         dt.int32)
        for name in MONEY_COLUMNS:
            lo = self.cols[name]
            cols[name] = gt.Column(lo, valid, dt.decimal128(15, 2),
                                   extra=torch.zeros_like(lo))
        for name in DATE_COLUMNS:
            cols[name] = gt.Column(self.cols[name], valid, dt.date32)
        for name, values in DICTIONARIES.items():
            cols[name] = gt.Column(self.cols[name], valid, dt.string,
                                   dictionary=pa.array(values))
        cols["l_comment"] = gt.Column(codes, valid, dt.string,
                                      dictionary=comments)
        return gt.Batch(cols, self.n)

    def _rounds(self):
        """Rounds of every query once, each in an order drawn from the
        seed."""
        while True:
            for k in self.rng.permutation(len(self.queries)):
                yield self.queries[k]

    def warm_shapes(self):
        """Every plan over the table twice, holding the first answers
        while the second runs, as the window's reservoir does."""
        held = [self.plans[q].evaluate_device(self.batch)
                for q in self.queries]
        for q in self.queries:
            self.plans[q].evaluate_device(self.batch)
        del held

    def next_request(self) -> Request:
        q = next(self._order)
        plan, batch = self.plans[q], self.batch
        return Request(q, self.n, lambda: plan.evaluate_device(batch),
                       facts=self.facts[q])

    def record(self, req: Request, result) -> None:
        """The survivors, for the byte counts; and the answer into the
        query's reservoir of one (each answer kept with the same
        chance)."""
        sel, out = result
        req.survivors = out.length
        q = req.label
        self.seen[q] += 1
        if int(self.rng.integers(0, self.seen[q])) == 0:
            self.kept[q] = (sel, out)

    def forget(self) -> None:
        """Drop the answers kept so far (those of the warm-up)."""
        self.kept = {}
        self.seen = {q: 0 for q in self.queries}

    def release(self) -> None:
        """Free the program's state; only the kept answers stay."""
        self.plans = self.batch = self._order = None

    def _answers(self):
        """The kept answers as plain tensors, by query."""
        for q, (sel, out) in self.kept.items():
            count = out.length
            cols = {}
            for name in self.types[q]:
                c = out.column(name)
                cols[name] = {
                    "data": c.data[:count],
                    "hi": None if c.extra is None else c.extra[:count],
                    "valid": c.validity[:count],
                    "dictionary": None if c.dictionary is None
                    else c.dictionary.to_pylist()}
            yield q, {"indices": sel.indices[:count].to(torch.int64),
                      "columns": cols}

    def _reference(self, q: str, money: str) -> dict:
        keep, outs = importlib.import_module(
            f"benchmark.reference.{q}").plain(self.cols, DICTIONARIES,
                                              money)
        return compare.scan_answer(keep, outs, self.types[q], DICTIONARIES)

    def control_answers(self):
        """The control in the program's place: the reference computed
        with float32 money, once a query."""
        for q in self.queries:
            yield q, self._reference(q, _plain.FLOAT32)

    def check(self, answers=None) -> dict:
        """Every kept answer (or ``answers``) against the reference on the
        same rows."""
        out = {"compared_answers": 0, "differing_selection": 0,
               "differing_values": 0}
        checked = set()
        for q, got in (self._answers() if answers is None else answers):
            want = self._reference(q, _plain.EXACT)
            for k, v in compare.compare_scan(got, want).items():
                out[k] += v
            out["compared_answers"] += 1
            checked.add(q)
        out["unchecked_queries"] = len(set(self.queries) - checked)
        return out
