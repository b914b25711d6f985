"""Calls inside a request's call that make the host wait for the device
(the runtime's stream, device and event synchronizations and blocking
copies, as the profiler records them), averaged over the traced requests.
A lower bound: a kernel library's own calls are seen only where the
profiler traces its runtime."""


def read(run):
    reqs = run.trace.requests
    return sum(r.syncs for r in reqs) / len(reqs)
