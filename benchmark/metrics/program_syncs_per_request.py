"""The program's own waits for the device in a request: its ``gt.sync.*``
spans, each a site that makes the host wait, counted once or by its
``reads`` counter where the site waits more than once (torch's bincount on
a card reads its input's min and max), averaged over the traced
requests."""
from benchmark.harness import spans


def read(run):
    p = spans.of(run)
    if p is None:
        return None
    n = sum(p.spans[i].counters.get("reads", 1) for i in p.held()
            if p.spans[i].name.startswith(spans.SYNC))
    return n / p.requests
