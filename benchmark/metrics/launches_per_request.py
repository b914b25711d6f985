"""Device operations (kernels, copies and sets) that the profiler records
for a request, averaged over the traced requests."""


def read(run):
    reqs = run.trace.requests
    return sum(len(r.device) for r in reqs) / len(reqs)
