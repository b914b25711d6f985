"""The closed loop: one caller, each request sent when the last is done.

Each request is timed by two CUDA events recorded on the current stream
around the call. The stream is idle when a request starts (the loop waits
for the last one), so the first event stamps the call's start, and the
second stamps the later of the call's return and the end of its device
work: the request's latency from its call until its outputs are complete
on the device, read on the device's clock. On the CPU (the tests only)
the host's clock stands in.
"""
from __future__ import annotations

import sys
import time
import traceback
from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional

import torch


@dataclass
class Request:
    """One request: its label (the query), the rows it scans, and the call
    that serves it. The loop fills in the rest."""
    label: str
    rows: int
    call: Callable[[], Any]
    key: Any = None
    latency_ms: float = 0.0
    failed: bool = False
    survivors: Optional[int] = None
    facts: Optional[dict] = None


@dataclass
class Window:
    """What a closed loop completed: its requests in order, and its length
    on the host's clock."""
    requests: List[Request] = field(default_factory=list)
    seconds: float = 0.0
    start: float = 0.0


def closed_loop(next_request: Callable[[], Request],
                record: Callable[[Request, Any], None], seconds: float,
                annotate: bool = False, on_card: bool = True) -> Window:
    """Send requests from ``next_request`` for ``seconds`` of the host's
    clock; each result goes to ``record``. ``annotate`` marks each request
    and each call with a profiler span (``bench.request``, ``bench.call``)
    for the traced run."""
    from torch.profiler import record_function

    if on_card:
        begin = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
    win = Window(start=time.perf_counter())
    told = False
    while True:
        req = next_request()
        if annotate:
            outer = record_function("bench.request")
            outer.__enter__()
        if on_card:
            begin.record()
        called = time.perf_counter()
        try:
            if annotate:
                with record_function("bench.call"):
                    result = req.call()
            else:
                result = req.call()
        except Exception:                     # a failed request is counted
            req.failed, result = True, None
            if not told:
                traceback.print_exc(file=sys.stderr)
                told = True
        if on_card:
            end.record()
            end.synchronize()
        if annotate:
            outer.__exit__(None, None, None)
        now = time.perf_counter()
        req.latency_ms = (begin.elapsed_time(end) if on_card
                          else (now - called) * 1e3)
        if not req.failed:
            record(req, result)
        win.requests.append(req)
        if now - win.start >= seconds:
            win.seconds = now - win.start
            return win
