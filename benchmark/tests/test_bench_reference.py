"""The plain references against the program's CPU route, on a small
LINEITEM and a small ORDERS ⋈ CUSTOMER made by the benchmark's own
generators."""

import gandiva_tpu_torch as gt
import numpy as np
import pytest
import torch

from benchmark.data.orders_customer import MKTSEGMENTS, orders_customer
from benchmark.drivers.lineitem_scans import Driver as Scans
from benchmark.harness import compare
from benchmark.harness.loop import Request
from benchmark.reference import orders_customer as plain_groups

QUERIES = ["tpch_q1", "tpch_q6", "tpch_q7", "tpch_q12", "tpch_q19"]
CONFIG = {"queries": QUERIES}
ROWS = 4096


@pytest.fixture(scope="module")
def scans():
    return Scans(gt, CONFIG, {}, 2**31 + 11, torch.device("cpu"), ROWS)


@pytest.mark.parametrize("q", QUERIES)
def test_scan_reference_matches_program(scans, q):
    sel, out = scans.plans[q].evaluate_device(scans.batch)
    scans.forget()
    scans.record(Request(q, ROWS, None), (sel, out))
    (_, got), = scans._answers()
    want = scans._reference(q, "exact")
    assert got["indices"].numel() > 0
    assert compare.compare_scan(got, want) == {"differing_selection": 0,
                                               "differing_values": 0}


def test_scan_comparison_sees_one_changed_value(scans):
    sel, out = scans.plans["tpch_q6"].evaluate_device(scans.batch)
    want = scans._reference("tpch_q6", "exact")
    got = {"indices": sel.indices[:out.length].long(),
           "columns": {"revenue": {
               "data": out.column("revenue").data[:out.length].clone(),
               "hi": out.column("revenue").extra[:out.length],
               "valid": out.column("revenue").validity[:out.length],
               "dictionary": None}}}
    got["columns"]["revenue"]["data"][0] += 1
    assert compare.compare_scan(got, want)["differing_values"] == 1


@pytest.mark.parametrize("x", [11_765_000, 38_364_700])   # 60%, 0.46%
def test_groups_reference_matches_program(x):
    t = orders_customer(20_000, 80_000, 2_000, 2**31 + 5,
                        torch.device("cpu"))
    mesh = gt.parallel.make_mesh(1, device="cpu")
    keys, sums, counts, metrics = gt.parallel.run_pipeline_with_retry(
        mesh, t["o_custkey"], t["o_totalprice"], t["c_custkey"],
        t["c_mktsegment"], filter_threshold=x)
    want = plain_groups.plain(t, x, len(MKTSEGMENTS))
    assert want[3] > 0 and len(want[0]) == len(MKTSEGMENTS)
    assert compare.compare_groups((keys, sums, counts, metrics["join_out"]),
                                  want) == {"differing_answers": 0,
                                            "sum_error": 0}


def test_groups_reference_against_numpy():
    """The torch reference against a NumPy one written another way (a
    dictionary join and np.add.at)."""
    t = orders_customer(5_000, 20_000, 500, 7, torch.device("cpu"))
    n = {k: v.numpy() for k, v in t.items()}
    seg_of = dict(zip(n["c_custkey"].tolist(), n["c_mktsegment"].tolist()))
    keep = n["o_totalprice"] > 25_000_000
    segs = np.array([seg_of.get(k, -1) for k in n["o_custkey"][keep]])
    amt = n["o_totalprice"][keep][segs >= 0]
    segs = segs[segs >= 0]
    sums = np.zeros(5, np.int64)
    np.add.at(sums, segs, amt)
    counts = np.bincount(segs, minlength=5)
    codes, s, c, j = plain_groups.plain(t, 25_000_000, 5)
    assert np.array_equal(codes, np.nonzero(counts)[0])
    assert np.array_equal(s, sums[counts > 0])
    assert np.array_equal(c, counts[counts > 0]) and j == len(segs)
