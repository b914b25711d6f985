"""The roofline metrics' byte counts against hand-worked values."""
import importlib

import gandiva_tpu_torch as gt
import pytest

from benchmark.harness import plans
from benchmark.metrics import k1_roofline_pct as k1
from benchmark.metrics import plan_kernel_roofline_pct as plan
from benchmark.metrics import scan_roofline_pct as scan


def facts(q):
    _, cond, exprs = importlib.import_module(
        f"benchmark.queries.{q}").build(gt)
    return plans.facts(cond, exprs)


def test_widths():
    assert plans.width("decimal128(15,2)") == 8       # fits one int64 word
    assert plans.width("decimal128(18,0)") == 8
    assert plans.width("decimal128(19,2)") == 16
    assert plans.width("decimal128(38,6)") == 16
    assert plans.width("date32") == 4
    assert plans.width("string") == 4                 # a dictionary index
    assert plans.width("int64") == 8
    with pytest.raises(ValueError):
        plans.width("list<int64>")


def test_q6_facts_and_bytes():
    f = facts("tpch_q6")
    assert f["condition"] == {"l_shipdate": 4, "l_discount": 8,
                              "l_quantity": 8}
    assert f["outputs"] == [{"name": "revenue", "width": 16, "field": None,
                             "reads": {"l_extendedprice": 8,
                                       "l_discount": 8}}]
    # 1,000 rows, 20 survive: the condition's 20 B a row; l_extendedprice
    # on the survivors; each survivor's index and 16 B revenue
    assert scan.scan_bytes(f, 1000, 20) == 20_000 + 160 + 20 * (4 + 16)
    assert plan.plan_bytes(f, 1000, 20) == 20_000 + 160
    assert k1.k1_bytes(f, 1000, 20) == 125 + 20 * (4 + 2 * 16)


def test_q1_facts_and_bytes():
    f = facts("tpch_q1")
    assert f["condition"] == {"l_shipdate": 4}
    assert [(o["name"], o["width"], o["field"]) for o in f["outputs"]] == [
        ("l_returnflag", 4, "l_returnflag"),
        ("l_linestatus", 4, "l_linestatus"),
        ("l_quantity", 8, "l_quantity"),
        ("l_extendedprice", 8, "l_extendedprice"),
        ("l_discount", 8, "l_discount"),
        ("disc_price", 16, None), ("charge", 16, None)]
    # 1,000 rows, 986 survive: outputs read 4+4+8+8+8 (fields) + 8 (l_tax)
    # = 40 B a survivor and write 4 + 64 B
    assert scan.scan_bytes(f, 1000, 986) == 4000 + 986 * 40 + 986 * 68
    # the plan kernel reads what the computed outputs need: l_extendedprice,
    # l_discount, l_tax
    assert plan.plan_bytes(f, 1000, 986) == 4000 + 986 * 24
    assert k1.k1_bytes(f, 1000, 986) == 125 + 986 * (4 + 2 * 64)


@pytest.mark.parametrize("q, columns", [
    ("tpch_q1", {"l_returnflag", "l_linestatus", "l_quantity",
                 "l_extendedprice", "l_discount"}),
    ("tpch_q7", {"l_orderkey", "l_suppkey"}),
    ("tpch_q12", {"l_orderkey", "l_shipmode"}),
    ("tpch_q19", {"l_partkey", "l_quantity", "l_extendedprice",
                  "l_discount"})])
def test_scans_project_what_their_query_needs_next(q, columns):
    """Each scan hands on the join keys and aggregate inputs that the rest
    of its TPC-H query reads."""
    assert columns <= {o["name"] for o in facts(q)["outputs"]}


def test_compaction_bytes():
    # chip_smoke.py's rows + survivors·(4 + 2·width), the mask at 1 bit
    assert k1.compaction_bytes(64, 3, 9) == 8 + 3 * 22
    assert k1.compaction_bytes(65, 0, 9) == 9


def test_kernel_names():
    assert plan.is_plan_kernel("gt_plan_kernel_0(gt_args_0)")
    assert k1.is_k1("void scatter_kernel<8, 3>(Params)")
    assert k1.is_k1("count_kernel")
    assert not k1.is_k1("gt_plan_kernel_0")
