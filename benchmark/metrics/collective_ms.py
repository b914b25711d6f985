"""Time a query in the program's collectives between processes
(``gt.collective.all_to_all``, ``.all_gather``, ``.all_reduce``: each NCCL
call of ``parallel/mesh.py``) on rank 0's card, on the device's clock: the
time between each span's two CUDA events, less that of the device spans
inside it. It holds the transfers and any wait for the other cards to
reach the same call."""
from benchmark.harness import spans

NAMES = ("gt.collective.all_to_all", "gt.collective.all_gather",
         "gt.collective.all_reduce")


def read(run):
    return spans.device_ms_per_request(run, NAMES)
