"""The share of the traced window in which no operation ran on the device
while the host's innermost open program span was one of the projector's
host pass (``gt.plan.*``, ``gt.compact``; not a ``gt.sync.*`` wait): the
idle that the host pass itself leaves, within ``device_idle_pct``."""
from benchmark.harness import spans


def read(run):
    p = spans.of(run)
    if p is None:
        return None
    t = run.trace
    return 100.0 * spans.idle_ns_under(t, p, spans.is_projector) / (
        t.end - t.start)
