"""Time a query in the join's probe and its payload gather
(``gt.join.probe``, ``gt.join.gather``) on the device's clock: the time
between each span's two CUDA events, less that of the device spans inside
it. It holds the spans' kernels and any idle of the device while the host
waits at a sync inside them, so removing such a wait moves it with no
change to the device's work."""
from benchmark.harness import spans


def read(run):
    return spans.device_ms_per_request(run, ("gt.join.probe",
                                             "gt.join.gather"))
