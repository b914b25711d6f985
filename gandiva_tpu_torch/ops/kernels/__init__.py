"""Hand-written CUDA kernels, their wrappers and their plain torch versions.

``LAUNCHES`` counts, per kernel, its launches on the card by its wrapper
(never the plain version), so a run can show which path it took. K1 counts
one per scatter launch: one per call for up to eight payload columns. K2
(``compact_fragnet``) counts its single pass and each scatter-only launch
for a later group of eight payloads: one per call for up to eight. K5
counts one per launch of its three-kernel sequence: one per call for up to
four value columns. K4 (``sort_block``) counts one per sort; K3
(``merge_path``) one per merge round, ⌈log2 ⌈n / W⌉⌉ of them per sort,
each round two launches (its partition pass and its merge). ``plan``
counts the plan compiler's generated kernels (compiler/jit.py), one per
launch: one per evaluation of a one-stage plan. ``join_build`` counts the
join build's run detection and placement (csrc/join_build.cu): two per
build on the card. ``join_probe`` counts the join probe (csrc/join_probe.cu):
one per probe of at least one row on the card. ``key_table`` counts the
key-table membership (csrc/key_table.cu): one per call of at least one key
on the card, two per query of the skew join on each held partition.
"""
from typing import Dict

LAUNCHES: Dict[str, int] = {"compact": 0, "compact_fragnet": 0,
                            "aggregate": 0, "sort_block": 0, "merge_path": 0,
                            "plan": 0, "join_build": 0,
                            "join_probe": 0, "key_table": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
