"""Byte counts shared by the roofline metrics: each column read once, over
the rows that need it, at its least width (``plans.width``). The
condition's columns are needed on every row; a column that only outputs
read is needed on the survivors alone."""
from __future__ import annotations


def condition_reads(facts: dict, rows: int) -> int:
    return rows * sum(facts["condition"].values())


def output_only_reads(facts: dict, survivors: int, computed: bool) -> int:
    """Bytes of the columns that only outputs read (``computed``: only
    those that computed outputs read), on the survivors."""
    cols = {}
    for o in facts["outputs"]:
        if computed and o["field"] is not None:
            continue
        cols.update(o["reads"])
    return survivors * sum(w for c, w in cols.items()
                           if c not in facts["condition"])


def output_writes(facts: dict, survivors: int) -> int:
    """Each survivor's 4 B selection index and its output values."""
    return survivors * (4 + sum(o["width"] for o in facts["outputs"]))
