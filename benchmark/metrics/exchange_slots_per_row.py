"""The slots the exchanges' receive buffers hold over the rows that moved
through them, summed over the traced requests' ``gt.exchange`` spans
(their counters ``slots`` and ``rows``): 1 where the buffers are sized by
the rows, more where a capacity pads them. A program whose exchange does
not count them gives nothing."""
from benchmark.harness import spans


def read(run):
    p = spans.of(run)
    if p is None:
        return None
    slots = rows = 0
    for i in p.held():
        s = p.spans[i]
        if s.name == "gt.exchange" and "slots" in s.counters:
            slots += s.counters["slots"]
            rows += s.counters["rows"]
    if not rows:
        return None
    return slots / rows
