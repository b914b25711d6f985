"""The program's spans and sync sites (``gandiva_tpu_torch/tracing.py``) on
the CPU: nothing is recorded outside a profiler session; inside one, a
FilterProject evaluation and a pipeline query record their span trees
under one request id each, on the profiler's own clock; every read that
makes the host wait for the device, as torch dispatches it, runs inside a
``gt.sync.*`` span; the store's bound; ``Projector.profile``'s span
track."""
import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function
from torch.utils._python_dispatch import TorchDispatchMode

import gandiva_tpu_torch as gt
from gandiva_tpu_torch import entrypoints, tracing
from gandiva_tpu_torch.compiler import jit

CPU = "cpu"
PROJECTOR = ("gt.plan.", "gt.compact")
OPERATORS = ("gt.filter", "gt.join.hot_keys", "gt.exchange",
             "gt.join.build", "gt.join.probe", "gt.join.gather",
             "gt.aggregate", "gt.sort")
# the operations through which torch makes the host wait for the device
SYNCING = ("_local_scalar_dense", "nonzero", "_unique", "_unique2",
           "unique_dim", "unique_consecutive", "masked_select")


@pytest.fixture(autouse=True)
def _empty_store():
    tracing.clear()
    yield
    tracing.clear()


def _recorded(fn):
    """Run ``fn`` under a CPU profiler session; returns its spans."""
    with profile(activities=[ProfilerActivity.CPU]):
        fn()
    return tracing.spans()


def _scan(compiled: bool):
    """Q12's LINEITEM scan (a string IN, dates, a projection) at 3,000
    rows on the CPU, on the eager or the compiled (host-built) route."""
    plan = entrypoints.tpch_q12_scan(CPU)
    if compiled:
        plan = jit.host_build(plan)
    return plan, entrypoints.lineitem(3000, 0, CPU)


def _pipeline_inputs():
    rng = np.random.default_rng(7)
    n, nb = 4096, 512
    return (torch.from_numpy(rng.integers(0, nb, n)),
            torch.from_numpy(rng.integers(0, 100, n)),
            torch.arange(nb), torch.from_numpy(rng.integers(0, 8, nb)))


def _run_pipeline():
    mesh = gt.parallel.make_mesh(1, device=CPU)
    return gt.parallel.run_pipeline_with_retry(mesh, *_pipeline_inputs(),
                                               num_groups=8)


def _check_tree(spans):
    """Parents open before and enclose their children; a root's request
    id is its own, every child shares its parent's."""
    for i, s in enumerate(spans):
        assert s.start <= s.end
        if s.parent < 0:
            continue
        p = spans[s.parent]
        assert s.parent < i and p.start <= s.start and s.end <= p.end
        assert s.request == p.request


def test_off_records_nothing():
    assert tracing.span("a") is tracing.span("b", device=torch.device(CPU)) \
        is tracing.sync("c")
    with tracing.span("a") as inner:
        tracing.add("rows_in", 5)
        assert inner is None
    plan, batch = _scan(False)
    plan.evaluate_device(batch)
    _run_pipeline()
    assert tracing.spans() == [] and tracing.dropped() == 0


@pytest.mark.parametrize("compiled", [False, True])
def test_filter_project_records_its_tree(compiled):
    plan, batch = _scan(compiled)
    out = []
    spans = _recorded(lambda: out.append(plan.evaluate_device(batch)))
    _check_tree(spans)
    root = spans[0]
    assert root.name == "gt.plan.evaluate" and root.parent == -1
    assert [s for s in spans if s.parent == -1] == [root]
    assert {s.request for s in spans} == {root.request}
    assert root.counters == {"rows_in": 3000, "rows_out": out[0][1].length}
    names = {s.name for s in spans}
    assert {"gt.plan.prepare", "gt.compact", "gt.sync.count",
            "gt.plan.outputs"} <= names
    assert ("gt.plan.launch" in names) == compiled
    assert ("gt.plan.host_tables" in names) == compiled
    assert all(s.name.startswith(PROJECTOR + ("gt.sync.",)) for s in spans)
    compact = next(s for s in spans if s.name == "gt.compact")
    assert compact.counters == {"payload_columns": 2}
    assert all(s.device_ms is None for s in spans)
    # a second evaluation is a request of its own
    more = _recorded(lambda: plan.evaluate_device(batch))
    assert more[len(spans)].request != root.request


def test_pipeline_records_its_tree():
    spans = _recorded(_run_pipeline)
    _check_tree(spans)
    root = spans[0]
    assert root.name == "gt.pipeline" and root.parent == -1
    assert root.counters == {"retries": 0}
    assert {s.request for s in spans} == {root.request}
    attempt = spans[1]
    assert attempt.name == "gt.pipeline.attempt" and attempt.parent == 0
    assert attempt.counters == {}
    children = {s.name for s in spans if s.parent == 1}
    assert set(OPERATORS) - {"gt.join.gather", "gt.join.build"} <= children
    by_name = {}
    for s in spans:
        by_name.setdefault(s.name, []).append(s)
    # the join's build and probe and the aggregate's exchange nest in them
    assert any(spans[s.parent].name == "gt.aggregate"
               for s in by_name["gt.exchange"])
    assert {"gt.sync.group_ids", "gt.sync.hot_table", "gt.sync.bincount",
            "gt.sync.walk", "gt.sync.fast_flag", "gt.sync.distinct",
            "gt.sync.rows_in", "gt.sync.n_groups", "gt.sync.overflow",
            "gt.sync.metrics", "gt.sync.results",
            "gt.sync.hot_isin"} <= set(by_name)
    assert len(by_name["gt.sync.results"]) == 3
    # torch's bincount reads its input's min and max on a card
    assert all(s.counters == {"reads": 2} for s in by_name["gt.sync.bincount"])
    # isin over 512 build and 4,096 probe keys with a table of 64 sorts
    # (64 >= 10·512^0.145 and 10·4096^0.145): three waits each
    assert [s.counters for s in by_name["gt.sync.hot_isin"]] == \
        [{"reads": 3}, {"reads": 3}]
    # on the CPU no span is timed on a card
    assert all(s.device_ms is None for s in spans)


@pytest.mark.parametrize("path", ["scan", "pipeline"])
def test_spans_lie_on_the_profilers_clock(path):
    """Every span lies inside the profiler's own interval of an enclosing
    ``record_function`` span: the two share one clock."""
    if path == "scan":
        plan, batch = _scan(False)
        call = lambda: plan.evaluate_device(batch)  # noqa: E731
    else:
        call = _run_pipeline
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            with record_function("outer"):
                call()
    outer = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.name() == "outer")
    spans = tracing.spans()
    roots = [s for s in spans if s.parent == -1]
    assert len(outer) == len(roots) == 3
    for s in spans:
        lo, hi = outer[[r.request for r in roots].index(s.request)]
        assert lo <= s.start <= s.end <= hi


def _mask_index(name, args) -> bool:
    """An ``index`` by a boolean mask, whose ``nonzero`` runs below the
    dispatch mode."""
    return name == "index" and any(
        t is not None and t.dtype in (torch.bool, torch.uint8)
        for t in args[1])


class _SyncWatch(TorchDispatchMode):
    """Records each syncing operation torch dispatches, with the name of
    the innermost open span then. It cannot see a read that dispatches
    nothing on the CPU (``.tolist()``, ``.cpu()``), a host value copied to
    a card, or torch's reads inside a card's kernels (bincount's min and
    max): ``test_every_runtime_sync_is_inside_a_sync_span`` on the card
    holds those."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name in SYNCING or _mask_index(name, args):
            st = tracing._STORE
            stack = st.stack()
            self.seen.append((name, st.names[stack[-1]] if stack else None))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("path", ["scan", "scan_compiled", "pipeline"])
def test_every_sync_is_inside_a_sync_span(path):
    if path == "pipeline":
        call = _run_pipeline
    else:
        plan, batch = _scan(path == "scan_compiled")
        call = lambda: plan.evaluate_device(batch)  # noqa: E731
    watch = _SyncWatch()
    with profile(activities=[ProfilerActivity.CPU]):
        with watch:
            call()
    assert watch.seen
    outside = [(op, where) for op, where in watch.seen
               if where is None or not where.startswith("gt.sync.")]
    assert not outside


def test_bound_drops_spans_and_their_children(monkeypatch):
    monkeypatch.setattr(tracing, "LIMIT", 3)
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("a"):
            with tracing.span("b"):
                tracing.add("n", 1)
        with tracing.span("c"):
            with tracing.span("d"):          # past the bound: dropped
                tracing.add("n", 1)
                with tracing.span("e"):      # inside a dropped span
                    pass
            tracing.add("n", 2)
    spans = tracing.spans()
    assert [s.name for s in spans] == ["a", "b", "c"]
    assert spans[1].counters == {"n": 1} and spans[2].counters == {"n": 2}
    assert tracing.dropped() == 2
    tracing.clear()
    assert tracing.spans() == [] and tracing.dropped() == 0


def test_profile_writes_a_span_track(tmp_path):
    plan, batch = _scan(False)
    out = plan.profile(batch, str(tmp_path))
    doc = json.loads((tmp_path / "trace.json").read_text())
    assert out == str(tmp_path) and os.path.exists(tmp_path / "trace.json")
    track = [e for e in doc["traceEvents"]
             if e.get("pid") == "gandiva_tpu_torch spans"
             and e.get("ph") == "X"]
    assert track[0]["name"] == "gt.plan.evaluate"
    assert {"gt.plan.prepare", "gt.compact", "gt.sync.nonzero"} <= \
        {e["name"] for e in track}
    assert track[0]["args"]["rows_in"] == 3000
    # the track lies on the profiler's timeline: inside its own span of
    # the plan's first torch operation's enclosing interval
    ops = [e for e in doc["traceEvents"] if e.get("cat") == "cpu_op"]
    first, last = min(e["ts"] for e in ops), max(e["ts"] for e in ops)
    assert track[0]["ts"] <= first and last <= track[0]["ts"] + \
        track[0]["dur"]
    assert tracing.spans() == []
