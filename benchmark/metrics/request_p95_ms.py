"""The 95th percentile (nearest rank) of every request's latency in the
window, from its call until its outputs are complete on the device."""
import math


def read(run):
    ms = sorted(r.latency_ms for r in run.window.requests)
    return ms[math.ceil(0.95 * len(ms)) - 1]
