"""Compaction K1's share of its roofline (kernels ``count_kernel`` and
``scatter_kernel``): ``compaction_bytes`` of ``chip_smoke.py`` (lines
316-322), the mask read once and each survivor's payload read and written
once with its 4 B index, with the mask counted at one bit a row and each
output at its least width, at the data-sheet bandwidth."""


def is_k1(name: str) -> bool:
    return "count_kernel" in name or "scatter_kernel" in name


def compaction_bytes(rows: int, survivors: int, width: int) -> int:
    return -(-rows // 8) + survivors * (4 + 2 * width)


def k1_bytes(facts: dict, rows: int, survivors: int) -> int:
    return compaction_bytes(rows, survivors,
                            sum(o["width"] for o in facts["outputs"]))


def read(run):
    reqs = [r for r in run.trace.requests if r.request.facts]
    need = took = 0
    for r in reqs:
        ns = r.device_ns(is_k1)
        if ns:
            need += k1_bytes(r.request.facts, r.request.rows,
                             r.request.survivors)
            took += ns
    if not took:
        return None
    return 100.0 * need / run.peak_bytes_per_s / (took / 1e9)
