"""The traced slice: a closed loop under ``torch.profiler``, reduced to
plain records that the per-layer metrics read.

Each request of the slice is a ``bench.request`` span, its call a
``bench.call`` span inside it. The loop waits for each request's device
work before the next starts, so a device operation belongs to the request
whose span holds its start.
"""
from __future__ import annotations

import bisect
from dataclasses import dataclass, field
from typing import Callable, List

from .loop import Request, Window, closed_loop

SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cuStreamSynchronize",
              "cuCtxSynchronize", "cuEventSynchronize", "cudaMemcpy",
              "cuMemcpyDtoH_v2")


@dataclass
class Op:
    name: str
    start: int                 # ns, on the profiler's clock
    end: int


@dataclass
class TracedRequest:
    request: Request
    span: Op                   # bench.request: the call and its wait
    call: Op                   # bench.call: the program's call alone
    device: List[Op] = field(default_factory=list)
    syncs: int = 0

    def device_ns(self, match: Callable[[str], bool] = lambda n: True
                  ) -> int:
        """Device time of this request's operations whose name matches."""
        return sum(o.end - o.start for o in self.device if match(o.name))


@dataclass
class TraceSlice:
    requests: List[TracedRequest]
    device: List[Op]           # every device operation in the window
    host: List[Op]             # host events: ops, runtime calls
    start: int
    end: int
    kinds: dict = field(default_factory=dict)   # events, host and device

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e9

    def busy_intervals(self) -> List[tuple]:
        """The union of device operations' intervals, clipped to the
        window, as sorted disjoint (start, end) pairs."""
        spans = sorted((max(o.start, self.start), min(o.end, self.end))
                       for o in self.device)
        merged: List[list] = []
        for s, e in spans:
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [tuple(m) for m in merged]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the idle time by
        what the host was doing (the innermost host event open at each
        gap's middle, in the request whose span holds it), in seconds."""
        by_op: dict = {}
        for o in self.device:
            by_op[o.name] = by_op.get(o.name, 0) + (o.end - o.start)
        busy = self.busy_intervals()
        edges = [self.start] + [x for iv in busy for x in iv] + [self.end]
        gaps = [(s, e) for s, e in zip(edges[0::2], edges[1::2]) if e > s]
        labels = self._host_at([(s + e) // 2 for s, e in gaps])
        idle: dict = {}
        for (s, e), label in zip(gaps, labels):
            idle[label] = idle.get(label, 0) + (e - s)

        def ranked(d):
            return [[k[:120], v / 1e9] for k, v in
                    sorted(d.items(), key=lambda kv: -kv[1])[:top]]

        return {"device_ops": ranked(by_op), "idle_gaps": ranked(idle)}

    def _host_at(self, times: List[int]) -> List[str]:
        """For each time (ascending), what the host was doing: the
        innermost host event open then, by one sweep over the events in
        the order they start (a thread's events nest)."""
        host = sorted(self.host, key=lambda o: o.start)
        starts = [r.span.start for r in self.requests]
        out, stack, k = [], [], 0
        for t in times:
            while k < len(host) and host[k].start <= t:
                while stack and stack[-1].end < host[k].start:
                    stack.pop()
                stack.append(host[k])
                k += 1
            while stack and stack[-1].end < t:
                stack.pop()
            i = bisect.bisect_right(starts, t) - 1
            if i < 0 or t > self.requests[i].span.end:
                out.append("between requests (the benchmark's loop)")
                continue
            inner = stack[-1].name if stack else "host code, no op"
            out.append(f"{self.requests[i].request.label}: {inner}")
        return out


def _on_device(e) -> bool:
    """Whether a profiler event ran on the card (a kernel, copy or set, or
    a device-side copy of an annotation)."""
    return "CUDA" in str(e.device_type())


def traced_loop(next_request: Callable[[], Request], record, seconds: float,
                on_card: bool = True):
    """Run the closed loop for ``seconds`` under the profiler; returns the
    loop's Window and the TraceSlice of it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if on_card:
        torch.cuda.synchronize()
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        win = closed_loop(next_request, record, seconds, annotate=True,
                          on_card=on_card)
    return win, reduce(prof.profiler.kineto_results.events(), win)


def _spans(found: dict, n: int, name: str) -> List[Op]:
    """The ``n`` host spans of one annotation (the profiler may copy an
    annotation onto the device's timeline too)."""
    if len(found.get("host", ())) == n:
        return sorted(found["host"], key=lambda o: o.start)
    raise RuntimeError(f"profiler recorded {name} spans "
                       f"{ {k: len(v) for k, v in found.items()} } for "
                       f"{n} requests")


def reduce(events, win: Window) -> TraceSlice:
    """Kineto's events of one traced loop → a TraceSlice."""
    device, host = [], []
    spans, calls, kinds = {}, {}, {}
    for e in events:
        where = "device" if _on_device(e) else "host"
        kinds[where] = kinds.get(where, 0) + 1
        op = Op(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
        if op.name in ("bench.request", "bench.call"):
            (spans if op.name == "bench.request" else calls).setdefault(
                where, []).append(op)
        elif where == "device":
            device.append(op)
        else:
            host.append(op)
    n = len(win.requests)
    reqs = [TracedRequest(r, s, c) for r, s, c in zip(
        win.requests, _spans(spans, n, "bench.request"),
        _spans(calls, n, "bench.call"))]
    starts = [r.span.start for r in reqs]
    for o in device:
        i = bisect.bisect_right(starts, o.start) - 1
        if i >= 0 and o.start <= reqs[i].span.end:
            reqs[i].device.append(o)
    cstarts = [r.call.start for r in reqs]
    for o in host:
        if o.name in SYNC_CALLS:
            i = bisect.bisect_right(cstarts, o.start) - 1
            if i >= 0 and o.start <= reqs[i].call.end:
                reqs[i].syncs += 1
    return TraceSlice(reqs, device, host, reqs[0].span.start,
                      reqs[-1].span.end, kinds)
