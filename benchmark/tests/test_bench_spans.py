"""The readers of the program's spans (``harness/spans.py`` and the six
metrics that use it) on a synthetic traced slice, and in a traced run of
each cell on the CPU."""
import time
from types import SimpleNamespace

import pytest

from benchmark.harness import main as harness
from benchmark.harness import spans
from benchmark.harness.loop import Request
from benchmark.harness.trace import Op, TracedRequest, TraceSlice
from benchmark.metrics import (aggregate_ms, exchange_ms, host_pass_idle_pct,
                               join_build_ms, join_probe_ms,
                               program_syncs_per_request)

MANIFEST = harness.load_manifest()


def _span(name, start, end, parent=-1, device_ms=None):
    return SimpleNamespace(name=name, start=start, end=end, parent=parent,
                           request=0, counters={}, device_ms=device_ms)


def _slice(device):
    """Two requests, [0, 100) and [100, 200) ns; ``device``: the device
    operations' (start, end)."""
    reqs = [TracedRequest(Request("q", 1, None),
                          Op("bench.request", s, s + 100),
                          Op("bench.call", s, s + 90)) for s in (0, 100)]
    return TraceSlice(reqs, [Op("k", s, e) for s, e in device], [], 0, 200)


def _run(trace, found):
    """A run whose program recorded ``found``."""
    run = SimpleNamespace(trace=trace)
    spans._LAST[:] = [trace, spans.assign(trace, found)]
    return run


def test_spans_belong_to_the_request_that_holds_them():
    found = [_span("gt.plan.evaluate", 5, 80),
             _span("gt.sync.count", 60, 70, parent=0),
             _span("gt.plan.evaluate", 95, 150),      # crosses a boundary
             _span("gt.plan.evaluate", 110, 190),
             _span("gt.sync.count", 120, 130, parent=3),
             _span("gt.sync.count", 140, 150, parent=3),
             _span("gt.plan.evaluate", 210, 220)]     # after the slice
    found[5].counters["reads"] = 2             # a site that waits twice
    p = spans.assign(_slice([]), found)
    assert p.request_of == [0, 0, -1, 1, 1, 1, -1]
    assert p.children[3] == [4, 5] and p.held() == [0, 1, 3, 4, 5]
    assert p.self_intervals(3) == [(110, 120), (130, 140), (150, 190)]
    run = _run(_slice([]), found)
    assert program_syncs_per_request.read(run) == 2.0   # (1 + 1 + 2) / 2
    assert spans.assign(_slice([]), found[-1:]) is None


def test_host_pass_idle_counts_only_the_projectors_own_idle():
    # device busy [10, 40) and [120, 180); the projector's spans leave
    # their children's intervals out, and a sync wait is not the host pass
    found = [_span("gt.plan.evaluate", 0, 100),
             _span("gt.plan.prepare", 0, 20, parent=0),
             _span("gt.compact", 30, 50, parent=0),
             _span("gt.sync.count", 50, 90, parent=0),
             _span("gt.pipeline", 100, 200),           # not the projector
             _span("gt.plan.launch", 150, 195, parent=4)]
    run = _run(_slice([(10, 40), (120, 180)]), found)
    # idle ∩ projector self: prepare [0, 10), compact [40, 50),
    # evaluate's own [20, 30) minus busy = 0, [90, 100) = 10, launch
    # [180, 195) = 15
    assert host_pass_idle_pct.read(run) == pytest.approx(
        100 * (10 + 10 + 10 + 15) / 200)


def test_device_readers_take_self_time_a_request():
    found = [_span("gt.pipeline.attempt", 1, 99, device_ms=50.0),
             _span("gt.join.hot_keys", 2, 10, parent=0, device_ms=4.0),
             _span("gt.exchange", 11, 20, parent=0, device_ms=6.0),
             _span("gt.sync.bincount", 12, 13, parent=2),
             _span("gt.join.build", 21, 30, parent=0, device_ms=10.0),
             _span("gt.join.probe", 31, 40, parent=0, device_ms=8.0),
             _span("gt.join.gather", 41, 45, parent=0, device_ms=2.0),
             _span("gt.aggregate", 46, 70, parent=0, device_ms=9.0),
             _span("gt.exchange", 47, 60, parent=7, device_ms=5.0),
             _span("gt.join.build", 101, 120, device_ms=20.0)]
    run = _run(_slice([]), found)
    assert join_build_ms.read(run) == 15.0        # (10 + 20) / 2
    assert join_probe_ms.read(run) == 5.0         # (8 + 2) / 2
    assert aggregate_ms.read(run) == 2.0          # (9 - 5) / 2
    assert exchange_ms.read(run) == 7.5           # (4 + 6 + 5) / 2
    p = spans.of(run)
    assert p.device_self_ms(0) == 50.0 - 4 - 6 - 10 - 8 - 2 - 9


def test_no_device_times_or_no_spans_report_nothing():
    run = _run(_slice([]), [_span("gt.join.build", 1, 9)])
    assert join_build_ms.read(run) is None
    run = _run(_slice([]), [])
    assert all(m.read(run) is None for m in (
        host_pass_idle_pct, program_syncs_per_request, join_build_ms,
        join_probe_ms, aggregate_ms, exchange_ms))


def test_a_store_past_its_bound_reports_nothing(monkeypatch):
    """Spans the store turned away would make every reader count short."""
    from gandiva_tpu_torch import tracing

    found = [_span("gt.plan.evaluate", 5, 80),
             _span("gt.sync.count", 60, 70, parent=0)]
    monkeypatch.setattr(tracing, "spans", lambda: found)
    run = SimpleNamespace(trace=_slice([]))
    spans._LAST[:] = [None, None]
    assert program_syncs_per_request.read(run) == 1 / 2
    monkeypatch.setattr(tracing, "dropped", lambda: 1)
    run = SimpleNamespace(trace=_slice([]))
    assert spans.of(run) is None
    assert all(m.read(run) is None for m in (
        host_pass_idle_pct, program_syncs_per_request, join_build_ms,
        join_probe_ms, aggregate_ms, exchange_ms))


@pytest.mark.parametrize("cell", [w["name"] for w in MANIFEST["workloads"]])
def test_traced_run_reports_the_program_span_metrics(cell):
    """A traced run of the cell on the CPU at a small size: the readers
    find the program's spans (no card: no device times, so the ms
    metrics stay out of the line)."""
    result, _, _ = harness.run_cell(cell, 2**31 + 7, 0.3, True,
                                    time.perf_counter(), device="cpu",
                                    rows=20_000, manifest=MANIFEST)
    m = result["metrics"]
    assert m["program_syncs_per_request"]["value"] >= 1
    if cell == "lineitem_scans_resident":
        assert 0 < m["host_pass_idle_pct"]["value"] <= 100
    assert not {"join_build_ms", "join_probe_ms", "aggregate_ms",
                "exchange_ms"} & set(m)
