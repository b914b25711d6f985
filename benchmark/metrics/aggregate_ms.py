"""Time a query in the distributed aggregate (``gt.aggregate``) less its
exchange, on the device's clock: the time between the span's two CUDA
events, less that of the device spans inside it. It holds the span's
kernels and any idle of the device while the host waits at a sync inside
it, so removing such a wait moves it with no change to the device's
work."""
from benchmark.harness import spans


def read(run):
    return spans.device_ms_per_request(run, ("gt.aggregate",))
