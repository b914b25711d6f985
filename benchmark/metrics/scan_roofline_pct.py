"""The least time the card's memory allows a whole scan, over all the
device time of the request: the bytes the query must move (each column
read once over the rows that need it; each survivor's 4 B index and its
output values written once) at the data-sheet bandwidth."""
from benchmark.harness import byte_counts as b


def scan_bytes(facts: dict, rows: int, survivors: int) -> int:
    return (b.condition_reads(facts, rows)
            + b.output_only_reads(facts, survivors, computed=False)
            + b.output_writes(facts, survivors))


def read(run):
    reqs = [r for r in run.trace.requests if r.request.facts]
    need = sum(scan_bytes(r.request.facts, r.request.rows,
                          r.request.survivors) for r in reqs)
    took = sum(r.device_ns() for r in reqs)
    if not took:
        return None
    return 100.0 * need / run.peak_bytes_per_s / (took / 1e9)
