"""The program's own spans in the traced slice, read once a run.

``gandiva_tpu_torch.tracing`` records spans while a profiler session
records: in a run of the benchmark, the traced slice alone. A span's start
and end are ``time.time_ns()`` readings, the clock the profiler stamps its
events with, so each span belongs to the traced request whose
``bench.request`` span holds it. A program without that module, one
that recorded no span inside a request, or one whose store reached its
bound (``tracing.dropped()``: it holds only part of the slice) gives None
here, and the readers of these spans then report nothing.

Self time: a span's host interval less its children's, and a device
span's CUDA-event time less that of the device spans nearest inside it,
so nested spans (the aggregate's exchange inside the aggregate) are not
counted twice.
"""
from __future__ import annotations

import bisect
import importlib
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

SYNC = "gt.sync."


def is_projector(name: str) -> bool:
    """A span of the projector's host pass (``compiler/projector.py``)."""
    return name.startswith("gt.plan.") or name == "gt.compact"


@dataclass
class ProgramSpans:
    spans: list                  # as ``tracing.spans()`` gives them
    request_of: List[int]        # the traced request holding each, or -1
    children: List[List[int]]    # each span's children, in order
    requests: int                # traced requests in the slice

    def held(self) -> List[int]:
        """Indices of the spans inside a traced request."""
        return [i for i, r in enumerate(self.request_of) if r >= 0]

    def self_intervals(self, i: int) -> List[Tuple[int, int]]:
        """Span i's host interval less its children's."""
        s, out, at = self.spans[i], [], self.spans[i].start
        for c in self.children[i]:
            c = self.spans[c]
            if c.start > at:
                out.append((at, c.start))
            at = max(at, c.end)
        if s.end > at:
            out.append((at, s.end))
        return out

    def device_self_ms(self, i: int) -> Optional[float]:
        """Span i's device time less that of the device spans nearest
        inside it; None if it was not timed on a card."""
        ms = self.spans[i].device_ms
        if ms is None:
            return None
        stack = list(self.children[i])
        while stack:
            c = stack.pop()
            if self.spans[c].device_ms is not None:
                ms -= self.spans[c].device_ms
            else:
                stack.extend(self.children[c])
        return ms


def assign(trace, spans: Sequence) -> Optional[ProgramSpans]:
    """``spans`` against the traced requests of ``trace`` (a TraceSlice);
    None if no span lies inside a request."""
    reqs = trace.requests
    starts = [r.span.start for r in reqs]
    request_of, children = [], [[] for _ in spans]
    for i, s in enumerate(spans):
        k = bisect.bisect_right(starts, s.start) - 1
        inside = k >= 0 and s.end <= reqs[k].span.end
        request_of.append(k if inside else -1)
        if s.parent >= 0:
            children[s.parent].append(i)
    if all(r < 0 for r in request_of):
        return None
    return ProgramSpans(list(spans), request_of, children, len(reqs))


_LAST: list = [None, None]       # (the trace, its ProgramSpans)


def of(run) -> Optional[ProgramSpans]:
    """The program's spans of ``run``'s traced slice, read from the
    program once a run."""
    if _LAST[0] is run.trace:
        return _LAST[1]
    try:
        tracing = importlib.import_module("gandiva_tpu_torch.tracing")
    except ImportError:
        found = None
    else:
        found = (None if tracing.dropped()
                 else assign(run.trace, tracing.spans()))
    _LAST[:] = [run.trace, found]
    return found


def device_ms_per_request(run, names: Sequence[str]) -> Optional[float]:
    """The device self time of the spans named ``names``, in ms, summed
    over the traced requests and divided by their number; None where no
    such span was timed on a card."""
    p = of(run)
    if p is None:
        return None
    times = [p.device_self_ms(i) for i in p.held()
             if p.spans[i].name in names]
    times = [t for t in times if t is not None]
    if not times:
        return None
    return sum(times) / p.requests


def _intersect(a: List[Tuple[int, int]], b: List[Tuple[int, int]]) -> int:
    """The length of the intersection of two sorted lists of disjoint
    intervals."""
    total = i = j = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_ns_under(trace, p: ProgramSpans, match: Callable[[str], bool]
                  ) -> int:
    """The time in the traced window when no device operation ran while
    the host's innermost open program span was one that ``match``es."""
    busy = trace.busy_intervals()
    edges = [trace.start] + [x for iv in busy for x in iv] + [trace.end]
    idle = [(s, e) for s, e in zip(edges[0::2], edges[1::2]) if e > s]
    inner = sorted(iv for i in p.held() if match(p.spans[i].name)
                   for iv in p.self_intervals(i))
    return _intersect(idle, inner)
