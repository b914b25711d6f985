"""The generated plan kernel's share of its roofline: the bytes that
evaluating the condition over every row and each computed output over the
survivors must read (each column once, at its least width), at the
data-sheet bandwidth, over the time of the kernels named
``gt_plan_kernel_*``."""
from benchmark.harness import byte_counts as b


def is_plan_kernel(name: str) -> bool:
    return "gt_plan_kernel_" in name


def plan_bytes(facts: dict, rows: int, survivors: int) -> int:
    return (b.condition_reads(facts, rows)
            + b.output_only_reads(facts, survivors, computed=True))


def read(run):
    reqs = [r for r in run.trace.requests if r.request.facts]
    need = took = 0
    for r in reqs:
        ns = r.device_ns(is_plan_kernel)
        if ns:
            need += plan_bytes(r.request.facts, r.request.rows,
                               r.request.survivors)
            took += ns
    if not took:
        return None
    return 100.0 * need / run.peak_bytes_per_s / (took / 1e9)
