"""The program's own spans and sync sites, recorded while a
``torch.profiler`` session records, on the profiler's clock.

- ``span(name, device=False)``: a context manager around a stretch of the
  host's work. While no profiler session records it returns one shared
  object that does nothing: one call of ``torch.autograd._profiler_enabled``
  a site, no allocation, no clock read. The profiler's own state is the
  switch; there is no setting of its own.
- ``sync(site)``: the span ``gt.sync.<site>`` around a read that makes the
  host wait for the device (``int``, ``bool``, ``.item()``, ``.tolist()``,
  ``.cpu()`` of a device tensor, a tensor made on the card from a host
  value, ``torch.cuda.synchronize``, or a library call that syncs inside
  it). Their count is the program's sync count (a site that waits more
  than once adds the count to its ``reads`` counter), their length the
  host's wait there.
- ``add(counter, n)``: adds the Python number ``n`` to a counter of the
  innermost open span (rows in and out, retries).
- ``spans()``: the recorded spans, device times read; ``clear()`` empties
  the store; ``dropped()`` counts the spans the bound turned away.

While a session records, each span is a ``Span``: its name, start and end
in ``time.time_ns()`` (the Unix clock, which the profiler stamps its own
events with, so both lie on one timeline), the index in ``spans()`` of the
span open around it (-1 for a root), a request id (new at a root span, an
entry point, and inherited by the spans inside it), and its counters. A
``device`` span on a card also records a pair of CUDA events on the
current stream, from a pool that takes back a pair once its work is done;
their elapsed time is the device time of the work the span enqueued on
that stream, in order. An event record is neither a device operation nor
a synchronization, and no span makes an event of the profiler's own. The
store keeps plain numbers in flat lists, so a long session adds no
objects for the garbage collector to walk.

The store holds at most ``LIMIT`` spans. Once it is full a new span, and
every span inside it, is counted by ``dropped()`` and not recorded, until
``clear()``. Call ``clear()`` with no span open.
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from typing import Dict, List, NamedTuple, Optional

import torch

LIMIT = 1 << 20                # spans a store holds: ≈ 100 MB at the most

_enabled = torch.autograd._profiler_enabled
_now = time.time_ns


class Span(NamedTuple):
    """One recorded span, as ``spans()`` gives it."""
    name: str
    start: int                 # ns, time.time_ns()
    end: int
    parent: int                # index in spans(), -1 for a root
    request: int
    counters: Dict[str, float]
    device_ms: Optional[float]  # a device span's CUDA-event time


class _Store:
    """The recorded spans as flat lists, each thread's open ones, the
    counters and CUDA events of the spans that have them, and the pool."""

    def __init__(self):
        self.local = threading.local()
        self.requests = itertools.count()
        self.pool: List[tuple] = []
        self.clear()

    def clear(self) -> None:
        self.names: List[str] = []
        self.starts: List[int] = []
        self.ends: List[int] = []
        self.parents: List[int] = []
        self.request_ids: List[int] = []
        self.counters: Dict[int, Dict[str, float]] = {}
        self.device_ms: Dict[int, float] = {}
        self.open_events: Dict[int, tuple] = {}   # open device spans
        self.pending: deque = deque()     # (index, events) in record order
        self.dropped = 0

    def stack(self) -> list:
        try:
            return self.local.stack
        except AttributeError:
            self.local.stack = []
            return self.local.stack

    def events(self) -> tuple:
        """A pair of timing events: the pool's, or the oldest pending pair
        whose work is done (read now), or a new pair."""
        if self.pool:
            return self.pool.pop()
        if self.pending and self.pending[0][1][1].query():
            i, pair = self.pending.popleft()
            self.device_ms[i] = pair[0].elapsed_time(pair[1])
            return pair
        return (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))

    def resolve(self) -> None:
        while self.pending:
            i, (begin, end) = self.pending.popleft()
            end.synchronize()
            self.device_ms[i] = begin.elapsed_time(end)
            self.pool.append((begin, end))


_STORE = _Store()


def _open(name: str, device) -> None:
    """Record the start of a span named ``name`` on this thread."""
    st = _STORE
    stack = st.stack()
    names = st.names
    i = len(names)
    if i >= LIMIT or (stack and stack[-1] < 0):
        st.dropped += 1
        stack.append(-1)
        return
    if stack:
        parent = stack[-1]
        request = st.request_ids[parent]
    else:
        parent, request = -1, next(st.requests)
    names.append(name)
    st.parents.append(parent)
    st.request_ids.append(request)
    st.ends.append(0)
    stack.append(i)
    if device is not None:
        stream = torch.cuda.current_stream(device)
        pair = st.events()
        pair[0].record(stream)
        st.open_events[i] = (pair, stream)
    st.starts.append(_now())


class _Close:
    """What ``span`` returns while a session records: the span was opened
    by the call, and the ``with`` statement's exit closes the innermost
    open span of the thread."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        end = _now()
        st = _STORE
        i = st.stack().pop()
        if i >= 0:
            st.ends[i] = end
            if st.open_events:
                opened = st.open_events.pop(i, None)
                if opened is not None:
                    pair, stream = opened
                    pair[1].record(stream)
                    st.pending.append((i, pair))
        return False


class _Off:
    """The span while no profiler session records: does nothing."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()
_CLOSE = _Close()


def span(name: str, device=False):
    """A span named ``name``, for a ``with`` statement; with ``device``,
    the torch.device whose current stream its work goes to, it is timed
    there too if that is a card."""
    if not _enabled():
        return _OFF
    _open(name, device if device is not False and device.type == "cuda"
          else None)
    return _CLOSE


def sync(site: str):
    """The span ``gt.sync.<site>``, for a ``with`` statement around a read
    that waits for the device."""
    if not _enabled():
        return _OFF
    _open("gt.sync." + site, None)
    return _CLOSE


def add(counter: str, n) -> None:
    """Add ``n`` (a Python number, never a tensor) to ``counter`` of the
    innermost open span."""
    if not _enabled():
        return
    stack = _STORE.stack()
    if stack and stack[-1] >= 0:
        c = _STORE.counters.setdefault(stack[-1], {})
        c[counter] = c.get(counter, 0) + n


def spans() -> List[Span]:
    """The recorded spans in the order they opened, device times read
    (which waits for the last device span's work)."""
    st = _STORE
    st.resolve()
    return [Span(*row, st.counters.get(i, {}), st.device_ms.get(i))
            for i, row in enumerate(zip(st.names, st.starts, st.ends,
                                        st.parents, st.request_ids))]


def dropped() -> int:
    """Spans not recorded since the last ``clear()``: the store was
    full."""
    return _STORE.dropped


def clear() -> None:
    """Empty the store (its pending CUDA events go back to the pool)."""
    st = _STORE
    st.pool.extend(pair for _, pair in st.pending)
    st.pool.extend(pair for pair, _ in st.open_events.values())
    st.clear()
