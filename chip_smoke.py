"""Drive the PyTorch/CUDA port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero; there is no CPU fallback):
  1. device   — the card's name and power limit (nvidia-smi), device count;
  2. build    — nvcc every csrc/*.cu for sm_90a, in parallel, printing the
                -Xptxas -v register / shared-memory / spill lines, and the
                entry points' generated plan sources beside them;
  3. kernels  — K1 (stream compaction) against its plain torch version on
                the card, bit-exact on [:count]: 64Mi rows with the
                flagship payloads (f64 + bool) at five densities, and a
                ragged 1,000,037 rows with int64/float32/int32/bool payloads,
                and again with 10 payloads (more than one scatter launch);
                the mask and payloads as views at offsets 1, 3 and 8 (also
                against K2); no payload (Filter.evaluate's indices only) at
                64Mi rows, 4 tiles +- 1 row and 1,000,037 rows;
  4. times    — K1, its plain version and the nearest PyTorch calls
                (nonzero + index_select) at 64Mi rows, density 0.474, with
                CUDA events, beside the least time the card's memory allows;
                K1 at densities 0.02, 0.474 and 0.97 and with no payload,
                its count pass and its scatter apart (and torch.cumsum of
                the tile counts, the scan the scatter does itself), each
                beside its byte bound and the bytes its mask's survivors
                touch in 32-byte sectors; K1's -Xptxas -v lines and the
                scatter's persistent grid;
  5. arrow    — make_filter_project(...).evaluate on the 1M-row Arrow batch
                of bench_reference/bench_arrow.py, row for row against
                pyarrow.compute, and Filter + Projector(selection) against
                the fused plan;
  6. stream   — flagship_stream over 4 batches of 64Mi rows made on the card
                from a seeded generator; the first batch's outputs held
                bit-exactly against the same plan through the plain
                compaction; rows/s, K1 launches, peak device memory, and
                device time by kernel for one call (torch.profiler);
  7. K5       — the one-pass GROUP BY against its plain torch version on the
                card: BASELINE configs[1]'s columns (100,000,000 rows, 64
                keys, f64 and then int64 values), and at a ragged 1,000,037
                rows with 10% null keys and values over int8, int32, uint32,
                uint64, f32 and f64 columns (two launches), at 64 and 1024
                groups, past 1024 distinct keys (overflow), count_all only,
                and the keys int64::min/max and 0; then one group (the
                private variant), 1024 distinct keys with one column and
                with 4 (with and without null keys) and 2 keys at gcap 1024
                (the shared variant, which the kernel picks at gcap 1024);
                bit-exact apart from f64 sums (rtol 1e-9: atomics add in a
                varying order);
  8. K5 times — K5, its plain version and the nearest PyTorch calls
                (torch.unique + index_add_ + scatter_reduce_) at the
                configs[1] shape, beside the least time the card's memory
                allows, with its time by work per row (count_all only, sum
                only, min/max only); 1024 groups x 4 distinct columns beside
                its own bound; the atomic and match instructions of every K5 kernel
                in the built library's SASS (cuobjdump);
  9. agg path — ops.hash_aggregate(...) as bench.py runs configs[1], on
                100,000,000 rows made on the card: rows/s (best of 3), K5
                launches, peak device memory, device time by kernel, and a
                call's host clock split into before K5's wrapper, inside it,
                the decode and the wait for the device; its groups held
                against K5's plain version and pyarrow; then (9b) the
                generic group-by (max_groups 4096, 3000 keys, 10,000,000
                rows: group_ids and segment_reduce, no K5) against pyarrow's
                group_by, with its rows/s;
 10. K4, K3   — the block sort and the merge-path round (and the round's
                partition pass) against their plain torch versions on the
                card, bit for bit: at configs[2]'s shape (100,000,000 int64
                keys as bench.py makes them) K4 and the first and last K3
                rounds; at a ragged 1,000,037 rows every round, for heavy
                ties, sorted and reversed input, all keys equal, four words
                (two nullable keys), 14 words (the tile halves), and at
                n = 4W + 1, n < W and n = 0;
 11. sort times — the -Xptxas -v lines of K4 and K3; K4 and the whole
                merge_sort at W = 2^11 .. 2^14 (one word); at the default W,
                K4, each K3 round and its partition pass, K3's mean round at
                T = 2^11 .. 2^13 outputs a CTA, the whole merge_sort,
                sort_columns, their plain versions and the nearest PyTorch
                calls (segmented torch.sort for a kernel, torch.sort +
                index_select for the operator) at the configs[2] shape,
                beside the least time the card's memory allows
                (merge_sort's: rows x (20 + R x 24) B);
 12. sort path — ops.sort_columns([SortKey(keys)], [payload]) as bench.py
                runs configs[2], on 100,000,000 rows made on the card, and
                again with 10% null keys nulls first: rows/s (best of 3), K4
                launches and K3 rounds (one and R a call, R from each run's
                tile), peak device memory, device time by kernel;
                perm held against the plain merge sort, sorted columns against
                keys[perm]; then a ragged multi-key sort against pyarrow;
 13. K2       — the single-pass look-back compaction against its plain
                version on the card, bit-exact on [:count], and against K1:
                64Mi rows with the flagship payloads at five densities (0 and
                1 among them), the ragged 1,000,037 rows with four payloads
                and with ten (two launches), n = 0, 1, 1,000 and 5 tiles
                less one row, the mask and payloads as views at offsets 1
                and 3 (not 16-B aligned), 2^28 rows at density 0.5, and 20
                calls back to back before any is checked;
 14. K2 times — K2, K1, K2's plain version and nonzero + index_select
                at 64Mi rows (density 0.474, flagship payloads) and at the
                cold-residue mask and int64 key payload of one configs[3]
                probe chunk, beside the least time the card's memory allows,
                and K2 built with three staging budgets (8, 16 and 48 bytes
                a row; 16 is the one the port launches), each held against
                the plain version first;
 15. join     — ops.join(probe, build, 100_000_000, "inner") as bench.py's
                configs[3] join runs it (Zipf(1.3) probe keys % 1,048,576
                made on the card, build arange(1,048,576)), then with
                build_unique=True: rows/s (best of 3), launches, outputs
                checked exactly (count == n, probe_idx == arange(n),
                build_idx == the probe keys); the join build's kernels
                against the plain chain and the join probe's kernel against
                the reference's probe chains on the card on one more call's
                build and probe;
 16. join_stream — the full configs[3]: 16 chunks of 64,000,000 probe rows
                made on the card from the seed and the chunk index against
                build arange(10,000,000), each reduced to a checksum: rows/s
                (best of 2), every chunk's checksum against
                n + Σ iota + Σ keys, the probe kernel's and K4/K3's
                launches, host syncs of one probe_chunk, peak and own device
                memory, device time by kernel for one call (torch.profiler);
                the join build's kernels and the join probe's kernel against
                the plain chains on one more call's largest build and probe;
 17. join vs Arrow — 4,194,341 Zipf probe rows (the hot path) × 1,000,003
                build rows, 10% null keys on both sides: all six join types
                and a two-key join_multi against pyarrow.acero's hashjoin,
                row for row after sorting the pairs, and the hot path's
                (start, len) against the dense path's;
 18. registry — every signature of the date/time, interval, hash and
                decimal registry (aliases included; decimals at precisions
                9, 18, 28 and 38, every pair for the binary functions,
                castDECIMAL to two targets) through make_projector on the
                card and on the CPU over 1,048,576 rows made from a numpy
                seed (5% nulls, dates 1600-01-01 .. 2400-12-31), bit for bit
                (floats by their bits); prints the count held by family;
                then int128 division by 10^2 and 10^10 by the port's
                limb route and by divmod128: equal bits, and both times;
 19. TPC-H    — the lineitem scans of TPC-H Q1, Q6 and Q7
                (make_filter_project, entrypoints.tpch_q1_scan /
                tpch_q6_scan / tpch_q7_scan) over SF10's
                59,986,052 LINEITEM rows made on the card (decimal(15,2)
                money columns, a date32 ship date): rows/s of one
                synchronized evaluate_device (best of 3), survivors, K1
                launches, peak device memory, the profiler's top 8 and busy
                share, a call's host clock split around K1 and the count's
                sync; the selection and every output exact against plain
                int64 on the card (Q7's l_year by the calendar), and the
                first 1,048,576 rows against pyarrow.compute (Q6, Q7's
                year and volume, and Q1's outputs but its charge);
 20. strings  — every signature that names a string or binary type (the
                string registry's, aliases included, the string-typed date
                functions, castVARCHAR(decimal) at four precisions) through
                make_projector on the card and on the CPU over 1,048,576
                rows, dictionaries of 1,000 values with multi-byte UTF-8 and
                empty strings, 5% nulls: codes, bits and dictionaries equal;
                prints the count held by family; each LIKE plan twice, its
                table_builds unchanged; then the host syncs and wall of one
                call on the routes that read device values back
                (castVARCHAR of a computed float and of a decimal, concat's
                per-row route) beside a LIKE plan;
 21. TPC-H strings — Q1 (with l_returnflag and l_linestatus), Q12 and Q19
                over SF10's LINEITEM made on the card, Q9 and Q16 over
                SF10's 2,000,000 PART rows and Q22 over SF10's 1,500,000
                CUSTOMER rows made on the host and brought in through
                from_arrow (timed, with the distinct/row ratio of the
                near-unique p_name), each plan compiled: one generated
                kernel reading the string nodes' host tables, nothing
                eager, then K1: rows/s of one synchronized evaluate_device
                (best of 3), survivors, K1's and the plan kernel's
                launches, peak memory, the profiler's top 8 and busy share,
                a cold call's host tables against a memoised call's, the
                host clock split around K1 and the count's sync; the
                selection and every output exact against plain torch on
                the card (strings as codes under the same dictionary
                object), and against pyarrow.compute on LINEITEM's first
                1,048,576 rows and all of PART and CUSTOMER.
 22. configs[4] — BASELINE configs[4]'s filter→join→agg→sort
                (parallel.run_pipeline_with_retry, the reference's factors)
                as TPC-H SF10 ORDERS ⋈ CUSTOMER grouped by market segment
                over make_mesh(4) on the one card: 15,000,000 orders made on
                the card (o_custkey as dbgen draws it, uniform and then
                Zipf(1.3) over the same customers), 1,500,000 customers;
                exact against pyarrow.acero; rows/s (best of 3), metrics,
                peak memory, host syncs a call, hot keys, partition
                balance, the profiler's top 8, launches; the join probe's
                kernel, K4 with K3's rounds, K5 and the join build's
                kernels against their plain versions on the inputs of each
                one's largest call in the pipeline;
 23. distributed_step — entrypoints.distributed_step over one configs[0]
                batch of 64Mi rows as 4 partitions, 1024 groups, against
                pyarrow's group_by; rows/s, launches (K1, K5), syncs; K1
                and K5 against their plain versions on their largest
                call's inputs;
 24. profile  — the flagship plan's profile (a Chrome trace that must name
                a CUDA kernel) and cost_analysis, in a fresh process;
 25. scaling  — measure_scaling_efficiency and measure_weak_scaling over
                1, 2 and 4 partitions of the one card at a small size (they
                run; partitions of one card measure no scaling efficiency);
 26. plan compiler — every registry signature with an emitter that names
                no string type compiled (sixteen generated kernels) against
                the eager route on the card over 1,048,576 rows with nulls
                and hazard rows, bit for bit (the math functions, the
                date/time, hash and rounding families and the 256-bit
                decimal multiply of operands of 19-38 digits among them);
                every string and binary signature with an emitter (four
                generated kernels reading their host tables) over
                dictionaries of 1,000 values with nulls, likewise; then
                configs[0]'s flagship_stream, TPC-H Q1, Q6, Q7, Q12 and Q19
                over SF10 LINEITEM, Q9 and Q16 over SF10 PART, Q22 over
                SF10 CUSTOMER and distributed_step, each plan's eager and
                compiled node count printed, each compiled against
                optimize=False
                at full size, bit for bit (selection, count, values,
                validities); rows/s of both routes (best of 3), the
                generated kernel's time beside its byte bound and the
                eager route's time over the same nodes, launches a call
                on each route, and cold and warm Make times; Q7's plan is
                one generated kernel, then K1, whose time on Q7's mask is
                printed beside its bound;
 27. join build — the join build's two kernels (csrc/join_build.cu) at
                orders_customer_pipeline's build (4,502,048 rows, SF10's
                1,500,000 customer keys valid, with perm) and at configs[3]'s
                stream build (10,000,000 rows) through build_join_table,
                table and all_unique bit for bit against the plain chain on
                the card; the two kernels' time (torch.profiler), the
                kernel route's (its zeros and its sort of the home slots
                included), the plain chain's and torch.cummin +
                torch.cummax's over the same rows, beside the kernels' byte
                bound;
 28. join probe — the join probe's kernel (csrc/join_probe.cu) at
                orders_customer_pipeline's probe (7,500,000 rows against
                its build of 4,502,048 rows, 1,500,000 customer keys valid,
                in T = 2^26 home slots) and at orders_customer_4chip's on
                one card (56,250,000 rows against 11,250,000 customer keys
                whose hash32 % 4 is 0, in T = 2^26), its (start, len) bit
                for bit against _probe_ranges_dense and, on the valid rows,
                _probe_ranges_hot on the card; the kernel's time (CUDA
                events), beside its byte bound, the two chains' times, one
                full-width 16-byte gather of the home slots (a round of
                theirs), and the launches and host syncs of one probe_chunk.
Phases 5-25 run the plans as Make builds them: compiled on the card
(Configuration.optimize, the default), apart from phases 18 and 20, which
hold every signature's own eager route. Phase 2 also builds the entry
points' generated plans and phase 26's, with the kernels, in parallel.
Then one {"kernels": [...]} line (K1's launches by path include every
scan and distributed_step; K2-K5's, the join build's and the join
probe's the configs[4] pipeline, where K2 launches no more since the
probe kernel; the plan kernel's every path of phase 26), and last
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

N_BIG = 64 << 20                 # bench.py's flagship batch (bench.py:54, 229)
N_RAGGED = 1_000_037
DENSITIES = (0.0, 0.02, 0.474, 0.97, 1.0)
FLAGSHIP_DENSITY = 0.474         # 0.499 (a > 500 of [0, 1000)) × 0.95 valid
STREAM_K = 4
ARROW_ROWS = 1_000_000
N_AGG = 100_000_000              # bench.py's configs[1] rows (bench.py:88-93)
AGG_GROUPS = 64
AGG_RTOL = 1e-9                  # f64 sums: ~1.56M atomic addends a group
N_GENERIC = 10_000_000           # the generic group-by's hold (3000 keys)
N_SORT = 100_000_000             # bench.py's configs[2] (bench.py:101-122)
I64_MIN = -(1 << 63)
N_HUGE = 1 << 28                 # 65,536 tiles: many more than are resident
BACK_TO_BACK = 20
N_JOIN = 100_000_000             # bench.py's configs[3] join (bench.py:236)
JOIN_BUILD = 1 << 20             # bench.py's BENCH_BUILD_ROWS default
N_JOIN_FULL = 1_024_000_000      # bench.py's join_full (bench.py:249-252)
JOIN_FULL_BUILD = 10_000_000
JOIN_CHUNKS = 16                 # bench.py's BENCH_JOIN_CHUNKS default
N_ARROW_PROBE = 4_194_341        # ≥ 2^22: the hot-key probe runs
N_ARROW_BUILD = 1_000_003
ARROW_KEYS = 500_000
JOIN_HOWS = ("inner", "left", "right", "full", "semi", "anti")
ACERO = {"inner": "inner", "left": "left outer", "right": "right outer",
         "full": "full outer", "semi": "left semi", "anti": "left anti"}
N_REGISTRY = 1 << 20             # phase 18's rows
REGISTRY_NULLS = 0.05
DEC_TYPES = ("decimal128(9,2)", "decimal128(18,4)", "decimal128(28,6)",
             "decimal128(38,10)")
DAY_FIRST, DAY_LAST = -135140, 157419   # 1600-01-01, 2400-12-31
MS_PER_DAY = 86_400_000
N_TPCH_PREFIX = 1 << 20          # phase 19's rows held against pyarrow


def log(*a):
    print(*a, flush=True)


def phase(name):
    log(f"== {name} (t={time.perf_counter() - T0:.1f}s)")


def peak_bandwidth(name: str) -> float:
    """Data-sheet HBM bandwidth (bytes/s) of the H100 part ``name``."""
    if "PCIe" in name:
        return 2.0e12
    if "NVL" in name:
        return 3.9e12
    return 3.35e12                # H100 SXM


def bits(t: torch.Tensor) -> torch.Tensor:
    """Bit patterns, so float comparisons are exact (and NaN-safe)."""
    if t.dtype.is_floating_point:
        return t.view({2: torch.int16, 4: torch.int32,
                       8: torch.int64}[t.element_size()])
    return t


def hold(got, want, what: str) -> float:
    """Kernel outputs ``got`` against plain ``want``, bit-exact on [:count];
    returns the largest absolute difference of the payload values."""
    gi, gc, gcount = got
    wi, wc, wcount = want
    c = int(wcount)
    if int(gcount) != c:
        raise AssertionError(f"{what}: count {int(gcount)} != {c}")
    if not torch.equal(gi[:c], wi[:c]):
        raise AssertionError(f"{what}: indices differ")
    err = 0.0
    for k, (g, w) in enumerate(zip(gc, wc)):
        if not torch.equal(bits(g[:c]), bits(w[:c])):
            raise AssertionError(f"{what}: payload {k} ({g.dtype}) differs")
        if c and g.dtype != torch.bool:
            err = max(err, float((g[:c].double() - w[:c].double())
                                 .abs().max()))
    return err


def compaction_bytes(rows: int, survivors: int, width: int) -> int:
    """The least bytes a stable compaction moves: the 1 B mask of every row
    read once, and per survivor its payloads (``width`` bytes in all) read
    once, its 4 B index and its payloads written once. K1 and K2 load a
    payload element only where its mask bit is set, so the rows that drop
    cost them no payload bytes either."""
    return rows + survivors * (4 + 2 * width)


def sector_bytes(mask: torch.Tensor, widths) -> int:
    """The bytes a stable compaction moves when the card reads whole 32-byte
    sectors, computed on the card from ``mask``: every sector of the mask,
    each payload column's sectors that hold a survivor (columns of
    ``widths`` bytes, starting on a sector), and the writes, a 4 B index and
    the payloads a survivor. Printed next to ``compaction_bytes``, never in
    its place."""
    n = mask.shape[0]
    survivors = int(mask.sum())
    total = -(-n // 32) * 32 + survivors * (4 + sum(widths))
    for w in widths:
        rows = 32 // w
        pad = torch.zeros((-n) % rows, dtype=torch.bool, device=mask.device)
        touched = torch.cat([mask, pad]).view(-1, rows).any(1)
        total += int(touched.sum()) * 32
    return total


def ptxas_lines(text: str):
    """The compiler's register, shared-memory and spill lines of a build."""
    return [line.strip() for line in text.splitlines()
            if "ptxas" in line or "spill" in line or "cached" in line]


def sass_atomics(lib) -> dict:
    """Per kernel of a built library, its atomic, match and barrier
    instructions as ``cuobjdump -sass`` lists them (a 64-bit shared-memory
    atomic that the card lacks shows as an ATOMS.CAST.SPIN compare-and-swap
    loop); printed, and None where the toolkit has no cuobjdump."""
    import re
    from gandiva_tpu_torch.ops.kernels import build

    tool = os.path.join(os.path.dirname(build.nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        log("cuobjdump not found: SASS not read")
        return None
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    counts, fn = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            k = re.search(r"(accumulate|finish|init)_kernelI?L?i?(\d*)E?L?b?"
                          r"(\d?)", m.group(1))
            fn = (f"{k.group(1)}<{k.group(2)},{k.group(3)}>" if k and
                  k.group(2) else k.group(1) if k else m.group(1)[-40:])
            continue
        m = re.search(r"\b((?:ATOMS|ATOMG|ATOM|RED|MATCH|REDUX)\.[A-Z0-9.]+"
                      r"|MEMBAR\.[A-Z.]+)", line)
        if m and fn:
            counts.setdefault(fn, {})
            counts[fn][m.group(1)] = counts[fn].get(m.group(1), 0) + 1
    for fn, c in counts.items():
        log(f"SASS {fn}: " + ", ".join(f"{k} x{v}" for k, v in
                                       sorted(c.items())))
    return counts


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def profile_call(fn, top=None):
    """Device time by kernel for one call of ``fn`` (torch.profiler; the
    ``top`` largest kernels printed, or all), and the device's busy share of
    that same call's synchronized wall time (the profiler's own overhead
    included). Returns (busy share, rows as (µs, launches, name) largest
    first); the share is None if the profiler sees no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t
    # device-side events only: a CPU op's entry repeats its kernels' time
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            us, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    rows = sorted(((us, n, name) for name, (us, n) in by_name.items()),
                  reverse=True)
    device_us = sum(r[0] for r in rows)
    if device_us == 0:
        log("profiler: no device time recorded (not measured)")
        return None, rows
    log(f"profiler: device time {device_us / 1e3:.3f} ms in one call "
        f"({sum(r[1] for r in rows)} launches); busy share of its own "
        f"{wall_s * 1e3:.3f} ms wall: {device_us / 1e6 / wall_s:.1%}")
    for us, n, key in rows[:top]:
        log(f"   {us / 1e3:9.3f} ms {n:4d}x  {us / device_us:6.1%}  "
            f"{key[:100]}")
    return device_us / 1e6 / wall_s, rows


def count_syncs(fn) -> int:
    """Host syncs the card reports for one call of ``fn``."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return sum("synchroniz" in str(w.message) for w in caught)


def hold_k5(got, want, kinds, what: str) -> float:
    """K5's outputs against its plain version's: bit-exact apart from f64
    sums (rtol AGG_RTOL); only the flag where the query overflows. Returns
    the largest absolute difference of the f64 sums."""
    from gandiva_tpu_torch.ops.kernels.aggregate import FLOAT64, ROW_SUM

    if bool(got.overflow) != bool(want.overflow):
        raise AssertionError(f"{what}: overflow {bool(got.overflow)} != "
                             f"{bool(want.overflow)}")
    if bool(want.overflow):
        return 0.0
    if int(got.count) != int(want.count) or \
            not torch.equal(got.keys, want.keys) or \
            not torch.equal(got.count_all, want.count_all):
        raise AssertionError(f"{what}: keys, group count or count_all "
                             "differ")
    err = 0.0
    for v, kind in enumerate(kinds):
        for r in range(4):
            g, w = got.acc[v, r], want.acc[v, r]
            if r == ROW_SUM and kind == FLOAT64:
                g, w = g.view(torch.float64), w.view(torch.float64)
                torch.testing.assert_close(g, w, rtol=AGG_RTOL, atol=0,
                                           equal_nan=True, msg=what)
                err = max(err, float((g - w).abs().nan_to_num().max()))
            elif not torch.equal(g, w):
                raise AssertionError(f"{what}: column {v} row {r} differs")
    return err


def drive_generic_groupby(gt, dev, g, aggs, runs: int):
    """Phase 9b: ``hash_aggregate`` past 1024 groups (no K5) over N_GENERIC
    rows of 3000 keys drawn from ``g``, best of ``runs`` synchronized walls,
    against pyarrow's group_by. Returns (rows/s, walls, groups). It takes
    the package as ``gt``, so one process can time another tree's."""
    import pyarrow as pa

    from gandiva_tpu_torch.ops.kernels import LAUNCHES, reset_launches

    gen_keys = torch.randint(0, 3000, (N_GENERIC,), generator=g,
                             device=dev) * 1_000_003 - 7
    gen_vals = torch.randn(N_GENERIC, generator=g, dtype=torch.float64,
                           device=dev)

    def generic_path():
        return gt.ops.hash_aggregate(gen_keys, aggs,
                                     {"v": (gen_vals, None)}, max_groups=4096)

    reset_launches()
    gen = generic_path()                                  # warm-up
    torch.cuda.synchronize()
    gen_walls = []
    for _ in range(runs):
        t = time.perf_counter()
        gen = generic_path()
        torch.cuda.synchronize()
        gen_walls.append(time.perf_counter() - t)
    if LAUNCHES["aggregate"] != 0:
        raise AssertionError("the generic group-by launched K5")
    gen_rows_s = N_GENERIC / min(gen_walls)
    cnt = int(gen["group_count"])
    order = torch.argsort(gen["keys"][:cnt])
    got_np = {k: v[:cnt][order].cpu().numpy() for k, v in gen.items()
              if v.dim()}
    oracle = pa.table({"k": gen_keys.cpu().numpy(),
                       "v": gen_vals.cpu().numpy()}).group_by("k").aggregate(
        [("v", "sum"), ("v", "count"), ("v", "min"), ("v", "max")]
    ).sort_by("k")
    if cnt != oracle.num_rows or bool(gen["overflow"]):
        raise AssertionError(f"generic group-by: {cnt} groups, pyarrow "
                             f"{oracle.num_rows}")
    for col, key in (("k", "keys"), ("v_count", "agg:v:count"),
                     ("v_min", "agg:v:min"), ("v_max", "agg:v:max")):
        if not np.array_equal(oracle.column(col).to_numpy(), got_np[key]):
            raise AssertionError(f"generic group-by: {key} != pyarrow {col}")
    np.testing.assert_allclose(got_np["agg:v:sum"],
                               oracle.column("v_sum").to_numpy(),
                               rtol=AGG_RTOL)
    log(f"n={N_GENERIC}: {cnt} groups equal to pyarrow group_by (sums "
        f"within rtol {AGG_RTOL}); walls_s="
        f"{[round(w, 6) for w in gen_walls]} rows/s={gen_rows_s:.6g}, no K5 "
        "launch")
    return gen_rows_s, gen_walls, cnt


def plain_merge_sort(words, w_log2):
    """``merge_sort``'s steps through K4's and K3's plain versions."""
    from gandiva_tpu_torch.ops.kernels.merge_path import (merge_round_plain,
                                                          num_rounds)
    from gandiva_tpu_torch.ops.kernels.sort_bitonic import block_sort_plain

    idx, cur = block_sort_plain(words, w_log2)
    for r in range(num_rounds(words.shape[1], w_log2)):
        cur, idx = merge_round_plain(cur, idx, 1 << (w_log2 + r))
    return idx, cur


def hold_sort(got, want, what: str) -> float:
    """A (perm, words) pair against its plain version's, bit for bit;
    returns the largest absolute difference of the permutations (0)."""
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        raise AssertionError(f"{what}: differs from the plain version")
    if got[0].numel() == 0:
        return 0.0
    return float((got[0].long() - want[0].long()).abs().max())


def sort_rounds_against_plain(words, what: str, every_round: bool = True,
                              w_log2: int = None) -> float:
    """K4 and then K3's rounds on ``words`` (tile 2^w_log2, by default
    ``tile_log2``'s), each held against its plain version on the same
    input; with ``every_round`` false only the first and last rounds are.
    Returns the largest absolute difference."""
    from gandiva_tpu_torch.ops.kernels import merge_path as k3
    from gandiva_tpu_torch.ops.kernels import sort_bitonic as k4

    if w_log2 is None:
        w_log2 = k4.tile_log2(words.shape[0])
    got = k4.block_sort_cuda(words, w_log2)
    torch.cuda.synchronize()
    err = hold_sort(got, k4.block_sort_plain(words, w_log2), f"{what} K4")
    idx, cur = got
    rounds = k3.num_rounds(words.shape[1], w_log2)
    for r in range(rounds):
        run = 1 << (w_log2 + r)
        got = k3.merge_round_cuda(cur, idx, run)
        torch.cuda.synchronize()
        if every_round or r in (0, rounds - 1):
            if not torch.equal(k3.merge_splits_cuda(cur, run),
                               k3.merge_splits_plain(cur, run)):
                raise AssertionError(f"{what} K3 round {r}: partition "
                                     "differs from the plain version")
            err = max(err, hold_sort(got[::-1], k3.merge_round_plain(
                cur, idx, run)[::-1], f"{what} K3 round {r}"))
        cur, idx = got
    log(f"{what}: {words.shape[0]} words, n={words.shape[1]}, W=2^{w_log2}: "
        f"K4 and {'every' if every_round else 'the first and last'} of "
        f"{rounds} K3 rounds (and their partition passes) match plain")
    return err


def zipf_keys(n: int, n_build: int, g: torch.Generator) -> torch.Tensor:
    """bench.py's configs[3] probe keys: Zipf(1.3) by the inverse transform
    floor(U^(-1/0.3)), U uniform in [1e-5, 1), modulo the build size."""
    u = torch.rand(n, generator=g, device=g.device) * (1.0 - 1e-5) + 1e-5
    return u.pow(-1.0 / 0.3).to(torch.int64) % n_build


def pair_codes(probe_idx, build_idx, nb: int) -> np.ndarray:
    """(probe, build) pairs, -1 for a missing side, as sorted int64 codes."""
    p = np.asarray(probe_idx, dtype=np.int64) + 1
    b = np.asarray(build_idx, dtype=np.int64) + 1
    return np.sort(p * (nb + 2) + b)


def acero_pairs(pt, bt, keys, how: str, nb: int) -> np.ndarray:
    """pyarrow.acero's hashjoin of the two tables, as ``pair_codes``."""
    res = pt.join(bt, keys=keys, join_type=ACERO[how], coalesce_keys=False)
    p = res.column("pv").fill_null(-1).to_numpy()
    b = res.column("bv").fill_null(-1).to_numpy() \
        if how not in ("semi", "anti") else np.full(len(p), -1)
    return pair_codes(p, b, nb)


# -- phase 18: the decimal, date/time, interval and hash registry ----------

def registry_cases(gt):
    """(name, argument type names, return or target type name, int32
    literal or None) of every signature of the date/time, hash and decimal
    registry that names no string or binary type: aliases included,
    decimals at DEC_TYPES (every pair of them for the binary functions),
    castDECIMAL to two targets of each."""
    from gandiva_tpu_torch.registry import decimal_ops

    reg = gt.global_registry()
    decs = [gt.batch.parse_dtype(t) for t in DEC_TYPES]
    for a in decs:
        for b in decs:
            decimal_ops.ensure_registered([a, b])
    mods = ("gandiva_tpu_torch.registry.datetime_ops",
            "gandiva_tpu_torch.registry.hash_ops",
            "gandiva_tpu_torch.registry.decimal_ops")
    cases = set()
    for sig in gt.get_registered_function_signatures():
        params = tuple(map(str, sig.param_types))
        fn = reg.lookup(sig.name, sig.param_types)
        named = [p for p in params if p.startswith("decimal")]
        if not (fn.impl.__module__ in mods or named) \
                or not set(named) <= set(DEC_TYPES):
            continue
        if {*params, str(sig.return_type)} & {"string", "binary"}:
            continue                        # phase 20's
        if fn.needs_return_type:           # castDECIMAL*: two targets
            k = DEC_TYPES.index(params[0]) if named else 1
            for target in {DEC_TYPES[(k + 1) % 4], DEC_TYPES[(k + 3) % 4]}:
                cases.add((sig.name, params, target, None))
        elif params[1:] == ("int32",) and named:   # round/truncate(d, s)
            cases.add((sig.name, params[:1], str(sig.return_type), 1))
        else:
            cases.add((sig.name, params, str(sig.return_type), None))
    return sorted(cases, key=str)


def registry_column(t: str, n: int, rng, amount: bool):
    """Random (data, validity, hi) numpy arrays of type ``t``, 5% nulls:
    dates over DAY_FIRST..DAY_LAST, decimals over their precision, and with
    ``amount`` small integers (the day and month counts of the date
    functions)."""
    valid = rng.random(n) >= REGISTRY_NULLS
    hi = None
    full = {"int8": np.int8, "int16": np.int16, "int32": np.int32,
            "int64": np.int64, "uint8": np.uint8, "uint16": np.uint16,
            "uint32": np.uint32, "uint64": np.uint64}
    if t.startswith("decimal128("):
        prec = int(t[len("decimal128("):].split(",")[0])
        if prec <= 18:
            data = rng.integers(1 - 10 ** prec, 10 ** prec, n)
            hi = np.where(data < 0, -1, 0)
        else:                       # |hi| below 10^prec / 2^64
            data = rng.integers(-(1 << 63), (1 << 63) - 1, n, endpoint=True)
            hi = rng.integers(-(10 ** prec >> 64), 10 ** prec >> 64, n)
        data[::97] = 0              # zero divisors
        hi[::97] = 0
    elif t == "date32":
        data = rng.integers(DAY_FIRST, DAY_LAST, n, endpoint=True
                            ).astype(np.int32)
    elif t in ("date64", "timestamp"):
        data = rng.integers(DAY_FIRST, DAY_LAST, n, endpoint=True) \
            * MS_PER_DAY + rng.integers(0, MS_PER_DAY, n)
    elif t == "time32":
        data = rng.integers(0, MS_PER_DAY, n).astype(np.int32)
    elif t == "time64":
        data = rng.integers(0, MS_PER_DAY * 1000, n)
    elif t == "interval_day":
        data = (rng.integers(-20000, 20000, n) << 32) \
            | rng.integers(0, MS_PER_DAY, n)
    elif t == "interval_year":
        data = rng.integers(-2400, 2400, n).astype(np.int32)
    elif t == "bool":
        data = rng.random(n) < 0.5
    elif t in ("float32", "float64"):
        data = (rng.standard_normal(n) * 1e6).astype(t)
        data[:5] = [0.0, -0.0, np.nan, np.inf, -np.inf]
    elif amount:
        data = rng.integers(-50000, 50000, n).astype(full[t])
    else:
        info = np.iinfo(full[t])
        data = rng.integers(info.min, info.max, n, dtype=full[t],
                            endpoint=True)
    return data, valid, hi


def same_column(got, want) -> bool:
    """A card column against a CPU column: validity, then the data's bits
    (NaN equal to NaN) and the high limb."""
    if not torch.equal(got.validity.cpu(), want.validity):
        return False
    g, w = got.data.cpu(), want.data
    if g.dtype.is_floating_point:
        nan = torch.isnan(w)
        if not torch.equal(torch.isnan(g), nan):
            return False
        g, w = g.masked_fill(nan, 0), w.masked_fill(nan, 0)
    if not torch.equal(bits(g), bits(w)):
        return False
    return want.extra is None or torch.equal(got.extra.cpu(), want.extra)


def hold_registry(gt, dev) -> dict:
    """Every registry case through make_projector on the card and on the
    CPU over N_REGISTRY rows; any difference fails. Returns the count of
    signatures held by family. The plans are eager (optimize off): this
    holds each signature's own torch route; phase 26 holds the compiled
    one."""
    rng = np.random.default_rng(18)
    cases = registry_cases(gt)
    columns = {}                # (type, position, amount) → both batches
    B, dt = gt.TreeExprBuilder, gt.dtypes
    held = {}
    t0 = time.perf_counter()
    for name, params, ret, lit in cases:
        amount = name not in ("hash32", "hash64", "hash", "hash32AsDouble",
                              "hash64AsDouble", "castDECIMAL",
                              "castDECIMALNullOnOverflow")
        for i, t in enumerate(params):
            key = (t, i, amount)
            if key not in columns:
                cols = {"c": (t, *registry_column(t, N_REGISTRY, rng,
                                                  amount))}
                columns[key] = tuple(
                    gt.from_columns_numpy(cols, N_REGISTRY, device=d)
                    .column("c") for d in (dev, "cpu"))
        fields = [dt.Field(f"a{i}", gt.batch.parse_dtype(t))
                  for i, t in enumerate(params)]
        args = [B.make_field(f) for f in fields]
        if lit is not None:
            args.append(B.make_int32_literal(lit))
        node = B.make_function(name, args, gt.batch.parse_dtype(ret))
        expr = B.make_expression(node, dt.Field("out", node.dtype))
        outs = []
        for k, d in enumerate((dev, "cpu")):
            batch = gt.Batch({f"a{i}": columns[(t, i, amount)][k]
                              for i, t in enumerate(params)}, N_REGISTRY)
            outs.append(gt.make_projector(dt.Schema(fields), [expr],
                                          config=eager_config(gt),
                                          use_cache=False, device=d)
                        .evaluate_device(batch).column("out"))
        if not same_column(*outs):
            raise AssertionError(f"{name}({', '.join(params)}) -> {ret}: "
                                 "the card differs from the CPU")
        family = ("decimal" if any(p.startswith("decimal") for p in params)
                  or ret.startswith("decimal") else
                  "hash" if name.startswith("hash") else "date/time")
        held[family] = held.get(family, 0) + 1
    log(f"{len(cases)} signatures held bit-exact, card against CPU, at "
        f"{N_REGISTRY} rows ({REGISTRY_NULLS:.0%} nulls, days "
        f"{DAY_FIRST}..{DAY_LAST}): {held}; "
        f"{time.perf_counter() - t0:.1f}s")
    return held


def time_pow10_division(dev) -> dict:
    """The port's division by 10^k (``int128.divmod_pow10``: long division
    over 32-bit limbs, the route of scale reduction, round, truncate and
    castBIGINT) against the reference's route (``divmod128`` by 10^k, its
    128-step loop) over N_REGISTRY decimal128(38,10) values: the same bits,
    and each route's time, on the card (CUDA events) and on the CPU (one
    call). Returns {k: {route: ms}}."""
    from gandiva_tpu_torch.utils import int128 as i128

    lo, _, hi = registry_column("decimal128(38,10)", N_REGISTRY,
                                np.random.default_rng(181), False)
    times = {}
    for k in (2, 10):
        ph, pl = i128.pow10_128(k)
        row = {}
        for where, d in (("card", dev), ("cpu", "cpu")):
            h, l = torch.from_numpy(hi).to(d), torch.from_numpy(lo).to(d)

            def limbs():
                return i128.divmod_pow10(h, l, k)

            def loop():
                return i128.divmod128(h, l, torch.full_like(h, ph),
                                      torch.full_like(l, pl))

            got, want = limbs(), loop()
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise AssertionError(f"divmod_pow10 by 10^{k} differs from "
                                     f"divmod128 on the {where}")
            if where == "card":
                row["card_limbs_ms"] = time_ms(limbs, 10, 2)
                row["card_divmod128_ms"] = time_ms(loop, 3, 1)
            else:
                for key, fn in (("cpu_limbs_ms", limbs),
                                ("cpu_divmod128_ms", loop)):
                    t = time.perf_counter()
                    fn()
                    row[key] = (time.perf_counter() - t) * 1e3
        times[k] = row
    log(f"int128 ÷ 10^k over {N_REGISTRY} rows, divmod_pow10 equal to "
        f"divmod128 bit for bit: {json.dumps(times)}")
    return times


# -- phase 19: the TPC-H Q1, Q6 and Q7 lineitem scans -----------------------

def plain_year(days: torch.Tensor) -> torch.Tensor:
    """The calendar year of each day since 1970-01-01, by a search over
    the first days of the years 1900 .. 2100 (Python's calendar)."""
    import datetime

    firsts = torch.tensor([(datetime.date(y, 1, 1)
                            - datetime.date(1970, 1, 1)).days
                           for y in range(1900, 2101)], device=days.device)
    return 1900 + torch.searchsorted(firsts, days.long(), right=True) - 1


def tpch_plain(batch, query: str):
    """The scan's selection and outputs in plain int64 on the card, at each
    output's result scale (no output of these scans reduces its scale):
    Q1 disc_price = ep·(100 − disc) at scale 4, charge = ep·(100 −
    disc)·(100 + tax) at scale 6, and its two flags' codes; Q6 revenue =
    ep·disc at scale 4; Q7 l_year by the calendar, volume = ep·(100 −
    disc) at scale 4."""
    from gandiva_tpu_torch import entrypoints as e

    c = {k: batch.column(k).data for k in batch.columns}
    ship, disc, qty = c["l_shipdate"], c["l_discount"], c["l_quantity"]
    ep, tax = c["l_extendedprice"], c["l_tax"]
    if query == "Q1":
        keep = ship <= e.Q1_SHIPDATE - e.Q1_DELTA
        outs = {"l_returnflag": c["l_returnflag"],
                "l_linestatus": c["l_linestatus"],
                "l_quantity": qty, "l_extendedprice": ep,
                "disc_price": ep * (100 - disc),
                "charge": ep * (100 - disc) * (100 + tax)}
    elif query == "Q7":
        keep = (ship >= e.Q7_FROM) & (ship <= e.Q7_TO)
        outs = {"l_year": plain_year(ship), "volume": ep * (100 - disc)}
    else:
        keep = ((ship >= e.Q6_FROM) & (ship < e.Q6_TO) & (disc >= 5)
                & (disc <= 7) & (qty < 2400))
        outs = {"revenue": ep * disc}
    return torch.nonzero(keep).flatten(), outs


def hold_tpch_prefix(gt, plan, batch, query: str) -> int:
    """The scan over the first N_TPCH_PREFIX rows against pyarrow.compute
    on the same rows (after to_arrow): the selection, and Q6's revenue,
    Q7's l_year (``pyarrow.compute.year``) and volume, and Q1's first
    three outputs (Q1's charge, of precision 49 before adjustment, is past
    pyarrow's decimal128)."""
    import datetime
    import decimal

    import pyarrow as pa
    import pyarrow.compute as pc

    m = N_TPCH_PREFIX
    prefix = batch.slice(0, m)
    arrow = gt.to_arrow(prefix)
    col = {k: arrow.column(k) for k in arrow.schema.names}

    def day(v):
        return pa.scalar(datetime.date(1970, 1, 1)
                         + datetime.timedelta(days=v), pa.date32())

    def dec(v, p, s):
        return pa.scalar(decimal.Decimal(v), pa.decimal128(p, s))

    from gandiva_tpu_torch import entrypoints as e
    if query == "Q1":
        keep = pc.less_equal(col["l_shipdate"],
                             day(e.Q1_SHIPDATE - e.Q1_DELTA))
        want = [col["l_returnflag"], col["l_linestatus"], col["l_quantity"],
                col["l_extendedprice"],
                pc.multiply(col["l_extendedprice"],
                            pc.subtract(dec("1", 1, 0), col["l_discount"]))]
    elif query == "Q7":
        keep = pc.and_(pc.greater_equal(col["l_shipdate"], day(e.Q7_FROM)),
                       pc.less_equal(col["l_shipdate"], day(e.Q7_TO)))
        want = [pc.year(col["l_shipdate"]),
                pc.multiply(col["l_extendedprice"],
                            pc.subtract(dec("1", 1, 0), col["l_discount"]))]
    else:
        keep = pc.and_(pc.and_(
            pc.and_(pc.greater_equal(col["l_shipdate"], day(e.Q6_FROM)),
                    pc.less(col["l_shipdate"], day(e.Q6_TO))),
            pc.and_(pc.greater_equal(col["l_discount"], dec("0.05", 3, 2)),
                    pc.less_equal(col["l_discount"], dec("0.07", 3, 2)))),
            pc.less(col["l_quantity"], dec("24", 2, 0)))
        want = [pc.multiply(col["l_extendedprice"], col["l_discount"])]
    sel, outs = plan.evaluate(prefix)
    idx = np.nonzero(keep.to_numpy(zero_copy_only=False))[0]
    if not np.array_equal(sel.to_numpy(), idx):
        raise AssertionError(f"{query}: selection differs from pyarrow")
    for got, w in zip(outs, want):
        if not got.equals(pc.filter(w, keep).cast(got.type)):
            raise AssertionError(f"{query}: an output differs from "
                                 "pyarrow.compute")
    return len(idx)


def host_split(plan, batch) -> dict:
    """Where one scan call's wall goes on the host (median of 7 calls, ms),
    read from the program's spans, which a CPU profiler session turns on:
    each child of the call's ``gt.plan.evaluate`` by name (preparing the
    columns and the context, the host tables, the eager nodes, the
    kernel's launch, K1's wrapper, the wait at ``int(count)``, the
    outputs), the rest of the call, and the device wait after it returns.
    The profiler's recording of each torch operation is inside these
    times, so they are not comparable with a split timed with no profiler
    session."""
    from torch.profiler import ProfilerActivity, profile

    from gandiva_tpu_torch import tracing

    parts = {}
    for _ in range(7):
        tracing.clear()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU]):
            plan.evaluate_device(batch)
            returned = time.time_ns()
            torch.cuda.synchronize()
            done = time.time_ns()
        spans = tracing.spans()
        call = {"device_wait": done - returned, "wall": done - spans[0].start,
                "rest": spans[0].end - spans[0].start}
        for s in spans[1:]:
            if s.parent == 0:
                key = s.name.split(".")[-1]
                call[key] = call.get(key, 0) + s.end - s.start
                call["rest"] -= s.end - s.start
        for key, ns in call.items():
            parts.setdefault(f"{key}_ms", []).append(ns / 1e6)
    tracing.clear()
    return {k: sorted(v)[len(v) // 2] for k, v in parts.items()}


def drive_tpch(gt, dev, smi: str) -> dict:
    """TPC-H Q1's, Q6's and Q7's scans over SF10's 59,986,052 LINEITEM rows
    made on the card: rows/s of one synchronized evaluate_device (best of 3),
    survivors, K1 launches, peak memory, the profiler's top 8 and busy
    share, a call's host clock split (``host_split``); every output held
    exactly against plain int64 on the card, and the first N_TPCH_PREFIX
    rows against pyarrow.compute. Returns K1's launches by scan."""
    from gandiva_tpu_torch import entrypoints as e
    from gandiva_tpu_torch.ops.kernels import LAUNCHES, reset_launches

    n = e.LINEITEM_SF10_ROWS
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    batch = e.lineitem(n, seed=19, device=dev)
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated() - base
    log(f"{n} LINEITEM rows resident: {resident} B")
    launches, report = {}, {}
    for query, make, per_call in (("Q1", e.tpch_q1_scan, 2),
                                  ("Q6", e.tpch_q6_scan, 1),
                                  ("Q7", e.tpch_q7_scan, 1)):
        plan = make(dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        reset_launches()
        plan.evaluate_device(batch)                 # warm-up (allocator)
        walls = []
        for _ in range(3):
            t = time.perf_counter()
            sel, out = plan.evaluate_device(batch)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
        launches[f"TPC-H {query} scan"] = LAUNCHES["compact"]
        peak = torch.cuda.max_memory_allocated()
        if LAUNCHES["compact"] != 4 * per_call:
            raise AssertionError(f"{query}: K1 launched "
                                 f"{LAUNCHES['compact']} times, not "
                                 f"{4 * per_call}")
        count = int(sel.count)
        idx, want = tpch_plain(batch, query)
        if count != idx.numel() or not torch.equal(
                sel.indices[:count].long(), idx):
            raise AssertionError(f"{query}: selection differs from plain")
        for name, w in want.items():
            c = out.column(name)
            w = w[idx]
            hi_ok = (torch.equal(c.extra[:count], w >> 63)
                     if c.extra is not None
                     else c.dictionary is batch.column(name).dictionary
                     if name in batch.columns else True)
            if not (torch.equal(c.data[:count], w) and hi_ok
                    and bool(c.validity[:count].all())):
                raise AssertionError(f"{query}: {name} differs from plain")
        del idx, want, sel, out
        prefix_rows = hold_tpch_prefix(gt, plan, batch, query)
        log(f"{query} ({smi}): {n / min(walls):.6g} rows/s, walls_s="
            f"{[round(w, 6) for w in walls]}; {count} survivors "
            f"({count / n:.2%}); K1 launches {launches[f'TPC-H {query} scan']}"
            f" (4 calls); max_memory_allocated={peak} (resident before the "
            f"first call {before}: the path's own {peak - before}); exact "
            f"against plain int64, and {prefix_rows} of the first "
            f"{N_TPCH_PREFIX} rows' survivors against pyarrow.compute")
        busy, rows = profile_call(lambda: plan.evaluate_device(batch), top=8)
        device_us = sum(r[0] for r in rows)
        k1_us = sum(r[0] for r in rows
                    if "count_kernel" in r[2] or "scatter_kernel" in r[2])
        if device_us:
            log(f"   K1 {k1_us / device_us:.1%} of the device time, the rest"
                f" (the generated kernel, copies) "
                f"{1 - k1_us / device_us:.1%}")
        host = host_split(plan, batch)
        log(f"{query} call, host clock (median of 7): " + ", ".join(
            f"{k} {v:.4f}" for k, v in host.items()))
        report[query] = {"rows_per_s": n / min(walls), "walls_s": walls,
                         "survivors": count, "max_memory_allocated": peak,
                         "own_memory": peak - before,
                         "device_busy_share": busy,
                         "device_ms": device_us / 1e3,
                         "k1_share": k1_us / device_us if device_us else None,
                         "k1_launches": launches[f"TPC-H {query} scan"],
                         "host_ms": host}
    log(json.dumps({"tpch_scans": {"rows": n, "resident_bytes": resident,
                                   "card": smi, **report}}))
    del batch
    return launches


# -- phase 20: the string and binary registry --------------------------------

STRING_SEED_WORDS = ["", "é", "日本語", "naïve façade", "ÄÖÜ äöü", "42", "-7",
                     "3.5", "1e10", "nan", " 12 ", "2020-03-01",
                     "1969-12-31", "1999-12-31 23:59:59", "2020-02-30",
                     "6172726F77", "00ff", "zz", "a_b%c", "ab\\cd", "kitten",
                     "  padded  ", "DELIVER IN PERSON", "MAIL"]
# per function: its literals after the column (positions ≥ 1)
STRING_LITERALS = {
    "btrim": ["ab "], "trim": ["ab "], "ltrim": ["ab "], "rtrim": ["a "],
    "castVARBINARY": [3], "castVARCHAR": [4], "substr": [2, 3],
    "substring": [-3, 2], "charSubstring": [0, 4], "left": [3],
    "right": [-2], "repeat": [3], "lpad": [8, "*-"], "rpad": [7, "ü"],
    "replace": ["ab", "XY"], "regexp_replace": ["[aeiou]+", "#"],
    "regexp_extract": ["([a-z]+)([0-9]*)", 1], "split_part": [" ", 2],
    "translate": ["abc", "xy"], "strpos": ["ab"], "position": ["a"],
    "levenshtein": ["kitten"], "like": ["%a_b%", "\\"], "ilike": ["%AB%"],
    "starts_with": ["a"], "ends_with": ["e"], "is_substr": ["ab"],
    "contains": ["b"], "regexp_matches": ["^[a-c]"],
    "regexp_like": ["[0-9]$"], "hash": [7], "hash32": [5], "hash64": [11],
    "to_date": ["YYYY-MM-DD", 0], "is_date": ["YYYY-MM-DD"],
    "next_day": ["tuesday"]}
STRING_TWO_COLUMNS = {"concat", "concatOperator", "||", "equal",
                      "not_equal", "less_than", "less_than_or_equal_to",
                      "greater_than", "greater_than_or_equal_to", "==",
                      "!=", "<", "<=", ">", ">=", "eq", "ne", "lt", "le",
                      "gt", "ge", "gte", "lte", "same"}
STRING_DICT = 1000                      # phase 20's distinct values


def string_cases(gt):
    """(name, parameter type names, return type name) of every signature
    that names a string or binary type: the string registry's, the
    string-typed date/time functions and castVARCHAR(decimal) at
    DEC_TYPES; aliases included."""
    from gandiva_tpu_torch.registry import decimal_ops

    for t in DEC_TYPES:
        decimal_ops.ensure_registered([gt.batch.parse_dtype(t)])
    text = ("string", "binary")
    cases = set()
    for sig in gt.get_registered_function_signatures():
        params = tuple(map(str, sig.param_types))
        named = [p for p in params if p.startswith("decimal")]
        if set(named) - set(DEC_TYPES):
            continue
        if (any(p in text for p in params) or str(sig.return_type) in text) \
                and sig.name not in ("isnull", "isnotnull"):
            cases.add((sig.name, params, str(sig.return_type)))
    return sorted(cases, key=str)


def string_dictionary(rng, kind: str, name: str):
    """STRING_DICT distinct values, multi-byte UTF-8 and empty strings
    among them (bytes for binary; base64 texts for unbase64)."""
    alphabet = list("abcdefxyzABC019 _%-:") + ["é", "日", "ü", "€"]
    words = list(dict.fromkeys(STRING_SEED_WORDS + [
        "".join(rng.choice(alphabet, rng.integers(1, 13)))
        for _ in range(2 * STRING_DICT)]))[:STRING_DICT]
    if name == "unbase64":
        import base64
        words = [base64.b64encode(w.encode()).decode() for w in words]
    if kind == "binary":
        return [w.encode() for w in words[:-4]] + [
            b"\xff\xfe", b"ab\x80", b"\x00\x01", b"\xc3"]
    return words


def string_column(t: str, n: int, rng, name: str):
    """(codes, validity, None, dictionary) of a string or binary column, or
    a registry_column for another type."""
    import pyarrow as pa

    if t not in ("string", "binary"):
        return (*registry_column(t, n, rng, False), None)
    values = string_dictionary(rng, t, name)
    valid = rng.random(n) >= REGISTRY_NULLS
    codes = np.where(valid, rng.integers(0, len(values), n), 0)
    return (codes.astype(np.int32), valid, None,
            pa.array(values, type=pa.string() if t == "string"
                     else pa.binary()))


def string_expr(gt, name, params, ret, fields):
    """The case's expression: the first argument a column, later ones
    literals (two columns for the comparisons and concat; chr/space, which
    take literals only, concatenated to a column; locate's needle a
    literal)."""
    B, dt = gt.TreeExprBuilder, gt.dtypes
    f = [B.make_field(x) for x in fields]

    def lit(v, t):
        if isinstance(v, str):
            return B.make_string_literal(v)
        return B.make_literal(v, gt.batch.parse_dtype(t))

    if name in ("chr", "space"):
        node = B.make_function("concat", [f[0], B.make_function(
            name, [lit(65 if name == "chr" else 3, params[0])], dt.string)],
            dt.string)
    elif name == "locate":
        node = B.make_function(name, [B.make_string_literal("ab"), f[0]]
                               + [lit(2, "int32")] * (len(params) == 3),
                               dt.int32)
    else:
        lits = STRING_LITERALS.get(name, [])
        args = f + [lit(lits[i], t) for i, t in
                    enumerate(params[len(f):])]
        node = B.make_function(name, args, gt.batch.parse_dtype(ret))
    return B.make_expression(node, dt.Field("out", node.dtype))


def same_string_column(got, want) -> bool:
    """same_column, and a string output's dictionary by value."""
    if not same_column(got, want):
        return False
    return want.dictionary is None or got.dictionary.equals(want.dictionary)


def hold_string_registry(gt, dev) -> dict:
    """Every signature that names a string or binary type through
    make_projector on the card and on the CPU over N_REGISTRY rows,
    dictionaries of STRING_DICT values, 5% nulls: codes, bits and
    dictionaries equal; any difference fails. Each LIKE plan evaluates
    twice on the card, and its table_builds must not grow. Returns the
    count held by family. The plans are eager (optimize off), as in
    phase 18."""
    rng = np.random.default_rng(20)
    cases = string_cases(gt)
    B, dt = gt.TreeExprBuilder, gt.dtypes
    held, like_builds = {}, {}
    t0 = time.perf_counter()
    for name, params, ret in cases:
        types = ("string",) if name in ("chr", "space", "locate") \
            else params[:2 if name in STRING_TWO_COLUMNS else 1]
        cols = {f"a{i}": (t, *string_column(t, N_REGISTRY, rng, name))
                for i, t in enumerate(types)}
        fields = [dt.Field(k, gt.batch.parse_dtype(c[0]))
                  for k, c in cols.items()]
        expr = string_expr(gt, name, params, ret, fields)
        cpu = gt.from_columns_numpy(cols, N_REGISTRY, device="cpu")
        outs = []
        for d, batch in ((dev, cpu.to(dev)), ("cpu", cpu)):
            plan = gt.make_projector(dt.Schema(fields), [expr],
                                     config=eager_config(gt),
                                     use_cache=False, device=d)
            outs.append(plan.evaluate_device(batch).column("out"))
            if d is dev and name in ("like", "ilike"):
                first = plan.stats.get("table_builds", 0)
                plan.evaluate_device(batch)
                like_builds[f"{name}{params}"] = (
                    first, plan.stats.get("table_builds", 0))
                if plan.stats.get("table_builds", 0) != first:
                    raise AssertionError(f"{name}{params}: the LIKE table "
                                         "was built again")
        if not same_string_column(*outs):
            raise AssertionError(f"{name}({', '.join(params)}) -> {ret}: "
                                 "the card differs from the CPU")
        family = ("decimal" if any(p.startswith("decimal") for p in params)
                  else "date/time" if name in ("to_date", "is_date",
                                               "castDATE", "castTIMESTAMP",
                                               "next_day")
                  else "LIKE and predicates" if ret == "bool"
                  else "hash" if name.startswith("hash") and ret != "string"
                  else "cast from string" if name.startswith("cast")
                  and params[0] == "string" and ret not in ("string",
                                                            "binary")
                  else "castVARCHAR/VARBINARY of numbers"
                  if name.startswith("cast") and params[0] not in ("string",
                                                                  "binary")
                  else "string → int" if ret.startswith("int")
                  else "string → string/binary")
        held[family] = held.get(family, 0) + 1
    log(f"{len(cases)} string and binary signatures held, card against "
        f"CPU (codes, bits and dictionaries), at {N_REGISTRY} rows, "
        f"dictionaries of {STRING_DICT} values, {REGISTRY_NULLS:.0%} nulls: "
        f"{held}; {time.perf_counter() - t0:.1f}s")
    log(f"LIKE plans, table_builds after one call and after two: "
        f"{like_builds}")
    return held


def string_route_syncs(gt, dev) -> dict:
    """Host syncs and wall of one call on each route that reads device
    values back (castVARCHAR of a computed float64 and of a decimal
    column, concat's per-row route) and of a LIKE plan, over N_REGISTRY
    rows: {route: (syncs, ms)}."""
    from gandiva_tpu_torch.registry import string_ops

    rng = np.random.default_rng(201)
    B, dt = gt.TreeExprBuilder, gt.dtypes
    cols = {"s": ("string", *string_column("string", N_REGISTRY, rng, "")),
            "t": ("string", *string_column("string", N_REGISTRY, rng, "")),
            "f": ("float64", *string_column("float64", N_REGISTRY, rng, "")),
            "d": ("decimal128(18,4)", *string_column(
                "decimal128(18,4)", N_REGISTRY, rng, ""))}
    batch = gt.from_columns_numpy(cols, N_REGISTRY, device=dev)
    schema = dt.Schema([dt.Field(k, c.dtype)
                        for k, c in batch.columns.items()])
    f = {x.name: B.make_field(x) for x in schema}
    plans = {
        "castVARCHAR(multiply(f, 2.0))": B.make_function("castVARCHAR", [
            B.make_function("multiply", [f["f"], B.make_double_literal(2.0)],
                            dt.float64)], dt.string),
        "castVARCHAR(decimal column)": B.make_function(
            "castVARCHAR", [f["d"]], dt.string),
        "concat(s, t), per-row route": B.make_function(
            "concat", [f["s"], f["t"]], dt.string),
        "like(s, '%a_%')": B.make_function(
            "like", [f["s"], B.make_string_literal("%a_%")], dt.bool_)}
    out = {}
    cap = string_ops.MAX_PRODUCT_DICT
    string_ops.MAX_PRODUCT_DICT = 1000      # below 1000 × 1000: per row
    try:
        for what, node in plans.items():
            plan = gt.make_projector(schema, [B.make_expression(
                node, dt.Field("out", node.dtype))], use_cache=False,
                device=dev)
            plan.evaluate_device(batch)
            syncs = count_syncs(lambda: plan.evaluate_device(batch))
            torch.cuda.synchronize()
            t = time.perf_counter()
            plan.evaluate_device(batch)
            torch.cuda.synchronize()
            out[what] = (syncs, (time.perf_counter() - t) * 1e3)
    finally:
        string_ops.MAX_PRODUCT_DICT = cap
    log(f"host syncs and wall (ms) of one call at {N_REGISTRY} rows: "
        + json.dumps(out))
    return out


# -- phase 21: the TPC-H string scans ---------------------------------------

def lineitem_code(name: str, value: str):
    """The code of ``value`` in LINEITEM's fixed dictionary of ``name``, or
    None if it is not there."""
    from gandiva_tpu_torch import entrypoints as e

    values = e.STRING_COLUMNS[name].to_pylist()
    return values.index(value) if value in values else None


def string_scan_plain(batch, query: str):
    """The scan's selection and outputs in plain torch on the card: codes
    against the fixed dictionaries' codes (LINEITEM), or against a host
    table of the dictionary's values made with Python's ``in``,
    ``startswith``, ``!=`` and slicing (PART, CUSTOMER); decimals as int64
    at their scale."""
    from gandiva_tpu_torch import entrypoints as e

    c = {k: batch.column(k).data for k in batch.columns}
    dev = next(iter(c.values())).device

    def on_values(name, pred):
        d = batch.column(name).dictionary.to_pylist()
        table = torch.tensor([pred(v) for v in d], device=dev)
        return table[c[name].long()]

    if query == "Q1":
        return tpch_plain(batch, "Q1")
    if query == "Q12":
        modes = [lineitem_code("l_shipmode", v) for v in ("MAIL", "SHIP")]
        keep = (torch.isin(c["l_shipmode"], torch.tensor(modes, device=dev,
                                                         dtype=torch.int32))
                & (c["l_commitdate"] < c["l_receiptdate"])
                & (c["l_shipdate"] < c["l_commitdate"])
                & (c["l_receiptdate"] >= e.Q12_FROM)
                & (c["l_receiptdate"] < e.Q12_TO))
        outs = {"l_shipmode": c["l_shipmode"]}
    elif query == "Q19":
        modes = [x for x in (lineitem_code("l_shipmode", v)
                             for v in ("AIR", "AIR REG")) if x is not None]
        q = c["l_quantity"]
        keep = (torch.isin(c["l_shipmode"], torch.tensor(
            modes, device=dev, dtype=torch.int32))
            & (c["l_shipinstruct"] == lineitem_code("l_shipinstruct",
                                                    "DELIVER IN PERSON"))
            & (((q >= 100) & (q <= 1100)) | ((q >= 1000) & (q <= 2000))
               | ((q >= 2000) & (q <= 3000))))
        outs = {"l_extendedprice": c["l_extendedprice"],
                "l_discount": c["l_discount"]}
    elif query == "Q9":
        keep = on_values("p_name", lambda v: e.Q9_COLOR in v)
        outs = {"p_partkey": c["p_partkey"]}
    elif query == "Q22":
        keep = (on_values("c_phone", lambda v: v[:2] in e.Q22_CODES)
                & (c["c_acctbal"] > 0))        # the low limb: |v| < 2^63
        outs = {"c_custkey": c["c_custkey"], "c_acctbal": c["c_acctbal"]}
    else:
        keep = (on_values("p_brand", lambda v: v != e.Q16_BRAND)
                & on_values("p_type", lambda v: not v.startswith(
                    e.Q16_TYPE))
                & torch.isin(c["p_size"], torch.tensor(
                    e.Q16_SIZES, device=dev, dtype=torch.int32)))
        outs = {n: c[n] for n in ("p_brand", "p_type", "p_size")}
    return torch.nonzero(keep).flatten(), outs


def string_scan_arrow(arrow, query: str):
    """The scan's predicate over an Arrow batch with pyarrow.compute
    (match_like, is_in, equal, not_equal, utf8_slice_codeunits and the
    date and decimal compares)."""
    import decimal

    import pyarrow as pa
    import pyarrow.compute as pc

    from gandiva_tpu_torch import entrypoints as e

    col = {k: arrow.column(k) for k in arrow.schema.names}

    def day(v):
        return pa.scalar(v, pa.int32()).cast(pa.date32())

    if query == "Q1":
        return pc.less_equal(col["l_shipdate"],
                             day(e.Q1_SHIPDATE - e.Q1_DELTA))
    if query == "Q12":
        return pc.and_(pc.and_(pc.and_(
            pc.is_in(col["l_shipmode"], value_set=pa.array(["MAIL",
                                                            "SHIP"])),
            pc.less(col["l_commitdate"], col["l_receiptdate"])),
            pc.less(col["l_shipdate"], col["l_commitdate"])), pc.and_(
            pc.greater_equal(col["l_receiptdate"], day(e.Q12_FROM)),
            pc.less(col["l_receiptdate"], day(e.Q12_TO))))
    if query == "Q19":
        q = col["l_quantity"]

        def between(lo, hi):
            def dec(v):
                return pa.scalar(decimal.Decimal(v), pa.decimal128(2, 0))

            return pc.and_(pc.greater_equal(q, dec(lo)),
                           pc.less_equal(q, dec(hi)))

        return pc.and_(pc.and_(
            pc.is_in(col["l_shipmode"], value_set=pa.array(["AIR",
                                                            "AIR REG"])),
            pc.equal(col["l_shipinstruct"], "DELIVER IN PERSON")),
            pc.or_(pc.or_(between(1, 11), between(10, 20)),
                   between(20, 30)))
    if query == "Q9":
        return pc.match_like(col["p_name"], f"%{e.Q9_COLOR}%")
    if query == "Q22":
        return pc.and_(
            pc.is_in(pc.utf8_slice_codeunits(col["c_phone"], 0, 2),
                     value_set=pa.array(list(e.Q22_CODES))),
            pc.greater(col["c_acctbal"], pa.scalar(
                decimal.Decimal("0.00"), pa.decimal128(3, 2))))
    return pc.and_(pc.and_(
        pc.not_equal(col["p_brand"], e.Q16_BRAND),
        pc.invert(pc.match_like(col["p_type"], f"{e.Q16_TYPE}%"))),
        pc.is_in(col["p_size"], value_set=pa.array(e.Q16_SIZES,
                                                   type=pa.int32())))


def hold_string_scan_arrow(plan, batch, arrow, query: str) -> int:
    """The plan over ``batch`` against pyarrow.compute over ``arrow`` (the
    same rows): the selection and every output pyarrow can compute
    (Q1's charge is past decimal128). Returns the survivors."""
    import pyarrow.compute as pc

    keep = string_scan_arrow(arrow, query)
    sel, outs = plan.evaluate(batch)
    idx = np.nonzero(keep.to_numpy(zero_copy_only=False))[0]
    if not np.array_equal(sel.to_numpy(), idx):
        raise AssertionError(f"{query}: selection differs from pyarrow")
    want = pc.filter(arrow, keep)
    names = set(arrow.schema.names)
    for e_, got in zip(plan.exprs, outs):
        name = e_.result_field.name
        if name in names and not got.equals(want.column(name)):
            raise AssertionError(f"{query}: {name} differs from pyarrow")
    return len(idx)


def table_split(plan_maker, batch) -> dict:
    """Host clock of a cold call (a new plan: its host tables built and
    uploaded) against a memoised call (the same plan again), each
    synchronized: wall, time inside ``add_table`` and tables built."""
    from gandiva_tpu_torch.compiler.decomposer import TraceContext

    real = TraceContext.add_table
    spent = []

    def timed(self, thunk, cache_on_dicts=False):
        t = time.perf_counter()
        try:
            return real(self, thunk, cache_on_dicts)
        finally:
            spent.append(time.perf_counter() - t)

    out = {}
    plan = plan_maker()
    TraceContext.add_table = timed
    try:
        for what in ("cold", "memoised"):
            spent.clear()
            builds = plan.stats.get("table_builds", 0)
            torch.cuda.synchronize()
            t = time.perf_counter()
            plan.evaluate_device(batch)
            torch.cuda.synchronize()
            out[what] = {"wall_ms": (time.perf_counter() - t) * 1e3,
                         "add_table_ms": sum(spent) * 1e3,
                         "tables": len(spent),
                         "built": plan.stats.get("table_builds", 0) - builds}
    finally:
        TraceContext.add_table = real
    if out["memoised"]["built"]:
        raise AssertionError("a memoised call built host tables again")
    return out


def drive_string_scans(gt, dev, smi: str):
    """TPC-H's string scans, each plan compiled (one generated kernel, no
    eager node: its string nodes read their host tables in the kernel),
    then K1: Q1 (with its two flags), Q12 and Q19 over SF10's 59,986,052
    LINEITEM rows made on the card, Q9 and Q16 over SF10 PART's 2,000,000
    rows and Q22 over SF10 CUSTOMER's 1,500,000 rows, made on the host and
    brought in through from_arrow. For each: rows/s of one synchronized
    evaluate_device (best of 3), survivors, K1's and the plan kernel's
    launches, peak memory, the profiler's top 8 and busy share, the host
    clock of a cold call against a memoised one (``table_split``) and
    around K1 and the count's sync (``host_split``); the selection and
    every output exact against plain torch on the card, and against
    pyarrow.compute on LINEITEM's first N_TPCH_PREFIX rows and on all of
    PART and CUSTOMER. Returns K1's and the plan kernel's launches by
    scan."""
    from gandiva_tpu_torch import entrypoints as e
    from gandiva_tpu_torch.ops.kernels import LAUNCHES, reset_launches

    launches, plan_launches, report = {}, {}, {}
    arrow_part = e.part_arrow(e.PART_SF10_ROWS, seed=21)
    ingest = []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        part = gt.from_arrow(arrow_part, device=dev)
        torch.cuda.synchronize()
        ingest.append(time.perf_counter() - t)
    sizes = {k: len(c.dictionary) for k, c in part.columns.items()
             if c.dictionary is not None}
    ratio = max(sizes.values()) / part.length
    log(f"PART: {part.length} rows through from_arrow in "
        f"{[round(w, 4) for w in ingest]} s ({smi}); dictionaries {sizes}, "
        f"distinct/row {ratio:.6f}")
    arrow_cust = e.customer_arrow(e.CUSTOMER_SF10_ROWS, seed=21)
    cust = gt.from_arrow(arrow_cust, device=dev)
    log(f"CUSTOMER: {cust.length} rows through from_arrow; c_phone's "
        f"dictionary {len(cust.column('c_phone').dictionary)} values")
    lineitem = e.lineitem(e.LINEITEM_SF10_ROWS, seed=21, device=dev)
    prefix = lineitem.slice(0, N_TPCH_PREFIX)
    arrow_prefix = gt.to_arrow(prefix)
    scans = (("Q1", e.tpch_q1_scan, lineitem, 2),
             ("Q12", e.tpch_q12_scan, lineitem, 1),
             ("Q19", e.tpch_q19_scan, lineitem, 1),
             ("Q9", e.tpch_q9_part_scan, part, 1),
             ("Q16", e.tpch_q16_part_scan, part, 1),
             ("Q22", e.tpch_q22_customer_scan, cust, 1))
    for query, make, batch, per_call in scans:
        n = batch.length
        split = table_split(lambda: make(dev), batch)
        plan = make(dev)
        if plan._program is None or plan._program.count("eager") \
                or plan._program.kernels != 1:
            raise AssertionError(f"{query}: the plan is not one generated "
                                 "kernel")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        reset_launches()
        plan.evaluate_device(batch)                 # warm-up (allocator)
        walls = []
        for _ in range(3):
            t = time.perf_counter()
            sel, out = plan.evaluate_device(batch)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
        table = ("PART" if batch is part else "CUSTOMER" if batch is cust
                 else "LINEITEM")
        key = f"TPC-H {query} {table} string scan"
        launches[key] = LAUNCHES["compact"]
        plan_launches[f"phase 21 {key}"] = LAUNCHES["plan"]
        if LAUNCHES["plan"] != 4:
            raise AssertionError(f"{query}: the plan kernel launched "
                                 f"{LAUNCHES['plan']} times, not 4")
        peak = torch.cuda.max_memory_allocated()
        if LAUNCHES["compact"] != 4 * per_call:
            raise AssertionError(f"{query}: K1 launched "
                                 f"{LAUNCHES['compact']} times, not "
                                 f"{4 * per_call}")
        count = int(sel.count)
        idx, want = string_scan_plain(batch, query)
        if count != idx.numel() or not torch.equal(
                sel.indices[:count].long(), idx):
            raise AssertionError(f"{query}: selection differs from plain")
        for name, w in want.items():
            c, w = out.column(name), w[idx]
            same = torch.equal(c.data[:count], w) and bool(
                c.validity[:count].all())
            if c.dtype.is_varlen:
                same = same and c.dictionary is batch.column(name).dictionary
            elif c.extra is not None:
                same = same and torch.equal(c.extra[:count], w >> 63)
            if not same:
                raise AssertionError(f"{query}: {name} differs from plain")
        del idx, want, sel, out
        builds = plan.stats.get("table_builds", 0)
        if batch is part:
            held = hold_string_scan_arrow(plan, part, arrow_part, query)
            where = f"all {n} PART rows"
        elif batch is cust:
            held = hold_string_scan_arrow(plan, cust, arrow_cust, query)
            where = f"all {n} CUSTOMER rows"
        else:
            held = hold_string_scan_arrow(plan, prefix, arrow_prefix, query)
            where = f"the first {N_TPCH_PREFIX} LINEITEM rows"
        log(f"{query} ({smi}): {n / min(walls):.6g} rows/s, walls_s="
            f"{[round(w, 6) for w in walls]}; {count} survivors "
            f"({count / n:.4%}); K1 launches {launches[key]}, plan kernel "
            f"launches {plan_launches[f'phase 21 {key}']} (4 calls); "
            f"max_memory_allocated={peak} (the path's own {peak - before});"
            f" exact against plain torch, and {held} survivors of {where} "
            f"against pyarrow.compute; table_builds {builds} over its 4 "
            "calls")
        busy, rows = profile_call(lambda: plan.evaluate_device(batch), top=8)
        device_us = sum(r[0] for r in rows)
        k1_us = sum(r[0] for r in rows
                    if "count_kernel" in r[2] or "scatter_kernel" in r[2])
        host = host_split(plan, batch)
        log(f"{query} call, host clock (median of 7): " + ", ".join(
            f"{k} {v:.4f}" for k, v in host.items()))
        log(f"{query} cold call against memoised (ms): {json.dumps(split)}")
        report[query] = {"rows": n, "rows_per_s": n / min(walls),
                         "walls_s": walls, "survivors": count,
                         "max_memory_allocated": peak,
                         "own_memory": peak - before,
                         "device_busy_share": busy,
                         "device_ms": device_us / 1e3,
                         "k1_share": k1_us / device_us if device_us else None,
                         "k1_launches": launches[key], "host_ms": host,
                         "tables": split}
    log(json.dumps({"string_scans": {"card": smi, "part_from_arrow_s": ingest,
                                     "part_distinct_ratio": ratio,
                                     **report}}))
    del lineitem, prefix, part, cust
    return launches, plan_launches


# -- phase 22: configs[4], TPC-H SF10 ORDERS ⋈ CUSTOMER over 4 partitions ---

ORDERS_SF10 = 15_000_000         # TPC-H v3.0.1 §4.2.3: SF × 1,500,000
CUSTOMER_SF10 = 1_500_000        # SF × 150,000
MKTSEGMENTS = 5                  # c_mktsegment's five values
PIPE_PARTITIONS = 4              # the layout of a 4-card deployment
PIPE_THRESHOLD = 25_000_000      # o_totalprice > 250,000.00, in cents
PIPE_ZIPF = 1.3                  # configs[3]'s skew
N_STEP = 64 << 20                # phase 23: one configs[0] batch
STEP_PARTITIONS = 4
STEP_GROUPS = 1024
SCALE_ROWS, SCALE_BUILD = 1 << 20, 1 << 17   # phase 25's strong scaling
WEAK_ROWS, WEAK_BUILD = 1 << 18, 1 << 15     # ... and weak, a partition


def orders_customer(dev, seed: int, zipf: bool):
    """SF10's ORDERS (o_custkey, o_totalprice in cents as int64) and
    CUSTOMER (c_custkey, c_mktsegment as a code in [0, 5)) made on the
    card. o_custkey is drawn, as dbgen draws it, over [1, 1,500,000]
    without the multiples of 3: uniform, or Zipf(1.3) over the same keys
    (configs[3]'s skew). o_totalprice is uniform in [90,000, 50,000,000]
    cents (reduced: not summed from lineitems)."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    n_keys = CUSTOMER_SF10 * 2 // 3          # customers that place orders
    j = zipf_keys(ORDERS_SF10, n_keys, g) if zipf else torch.randint(
        0, n_keys, (ORDERS_SF10,), generator=g, device=dev)
    o_custkey = 3 * (j // 2) + 1 + j % 2     # 1, 2, 4, 5, 7, ...
    o_totalprice = torch.randint(90_000, 50_000_001, (ORDERS_SF10,),
                                 generator=g, device=dev)
    c_custkey = torch.arange(1, CUSTOMER_SF10 + 1, device=dev)
    c_mktsegment = torch.randint(0, MKTSEGMENTS, (CUSTOMER_SF10,),
                                 generator=g, device=dev)
    return o_custkey, o_totalprice, c_custkey, c_mktsegment


def acero_configs4(tables):
    """The query by pyarrow.acero on host copies: filter, hash join,
    aggregate, order by."""
    import pyarrow as pa
    import pyarrow.compute as pc

    ok, amt, ck, seg = (t.cpu().numpy() for t in tables)
    orders = pa.table({"k": ok, "amt": amt})
    orders = orders.filter(pc.greater(orders.column("amt"), PIPE_THRESHOLD))
    joined = orders.join(pa.table({"k": ck, "seg": seg}), keys="k",
                         join_type="inner")
    agg = joined.group_by("seg").aggregate([("amt", "sum"),
                                            ("amt", "count")])
    agg = agg.sort_by("seg")
    return (agg.column("seg").to_numpy(), agg.column("amt_sum").to_numpy(),
            agg.column("amt_count").to_numpy(), joined.num_rows)


def clone_args(x):
    """``x`` with every tensor in it cloned (tuples, named tuples, lists)."""
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*map(clone_args, x))
    if isinstance(x, (list, tuple)):
        return type(x)(map(clone_args, x))
    return x


@contextlib.contextmanager
def keep_largest_inputs(kept: dict):
    """While open, the CUDA entries of K1, K2, K4, K5, the join build and
    the join probe keep in ``kept[name]`` clones of the arguments of their
    call with the most rows, so each can be held against its plain version
    at the shapes a path gives it."""
    from gandiva_tpu_torch.ops import hash_join as hj
    from gandiva_tpu_torch.ops.kernels import aggregate as k5
    from gandiva_tpu_torch.ops.kernels import compaction as k1
    from gandiva_tpu_torch.ops.kernels import compaction_fragnet as k2
    from gandiva_tpu_torch.ops.kernels import sort_bitonic as k4

    entries = [("compact", k1, "compact_columns_cuda"),
               ("compact_fragnet", k2, "compact_fragnet_cuda"),
               ("sort_block", k4, "block_sort_cuda"),
               ("aggregate", k5, "aggregate_cuda"),
               ("join_build", hj, "build_ranges_cuda"),
               ("join_probe", hj, "probe_ranges_cuda")]
    saved = [getattr(mod, attr) for _, mod, attr in entries]

    def recording(name, fn):
        def call(*args):
            if name not in kept or \
                    args[0].shape[-1] > kept[name][0].shape[-1]:
                kept[name] = clone_args(args)
            return fn(*args)
        return call

    for (name, mod, attr), fn in zip(entries, saved):
        setattr(mod, attr, recording(name, fn))
    try:
        yield kept
    finally:
        for (_, mod, attr), fn in zip(entries, saved):
            setattr(mod, attr, fn)


def hold_kept_kernels(kept: dict, what: str, need) -> dict:
    """The kernels named in ``need`` (K1 ``compact``, K2
    ``compact_fragnet``, K4 ``sort_block`` with K3's rounds, K5
    ``aggregate``, the join build's ``join_build``, the join probe's
    ``join_probe``) on the inputs ``keep_largest_inputs`` kept, each against
    its plain version. Returns the largest absolute difference of each (K4
    and K3 under ``sort``)."""
    from gandiva_tpu_torch.ops.kernels import aggregate as k5
    from gandiva_tpu_torch.ops.kernels import compaction as k1
    from gandiva_tpu_torch.ops.kernels import compaction_fragnet as k2

    missing = set(need) - kept.keys()
    if missing:
        raise AssertionError(f"{what}: no launch of {sorted(missing)}")
    errs = {}
    for name, cuda, plain in (
            ("compact", k1.compact_columns_cuda, k1.compact_columns_plain),
            ("compact_fragnet", k2.compact_fragnet_cuda,
             k2.compact_fragnet_plain)):
        if name in need:
            mask, cols = kept[name]
            errs[name] = hold(cuda(mask, cols), plain(mask, cols),
                              f"{name} {what}")
            log(f"{what}: {name} matches plain on its largest call "
                f"({mask.shape[0]} rows, {int(mask.sum())} kept, "
                f"{[c.dtype for c in cols]})")
    if "sort_block" in need:
        words, w_log2 = kept["sort_block"]
        errs["sort"] = sort_rounds_against_plain(
            words, f"{what} largest sort", w_log2=w_log2)
    if "aggregate" in need:
        keys, code, vcols, max_groups = kept["aggregate"]
        errs["aggregate"] = hold_k5(
            k5.aggregate_cuda(keys, code, vcols, max_groups),
            k5.aggregate_plain(keys, code, vcols, max_groups),
            [c.kind for c in vcols], f"K5 {what}")
        log(f"{what}: K5 matches plain on its largest call ({keys.shape[0]} "
            f"rows, {len(vcols)} columns, max_groups {max_groups})")
    if "join_build" in need:
        hold_join_build(kept["join_build"], f"{what} largest build")
        errs["join_build"] = 0.0
    if "join_probe" in need:
        hold_join_probe(kept["join_probe"], f"{what} largest probe")
        errs["join_probe"] = 0.0
    return errs


def hold_join_build(args, what: str) -> None:
    """The join build's kernels against the plain chain on the card, on the
    arguments (sorted keys, n_valid, perm, T) a build gave them: the table
    and all_unique bit for bit."""
    from gandiva_tpu_torch.ops import hash_join as hj
    from gandiva_tpu_torch.ops.kernels.join_build import build_ranges_cuda

    sk64, n_valid, perm, T = args
    got, got_unique = build_ranges_cuda(sk64, n_valid, perm, T)
    want, want_unique = hj._build_ranges_plain(sk64, n_valid, perm, T)
    if not torch.equal(got, want) or bool(got_unique) != bool(want_unique):
        raise AssertionError(f"join build {what}: the kernels' table or "
                             "all_unique differs from the plain chain's")
    log(f"{what}: the join build's table ({sk64.shape[0]} rows, "
        f"{int(n_valid)} valid, {got.shape[0]} slots, perm "
        f"{'given' if perm is not None else 'none'}) and all_unique "
        f"{bool(got_unique)} equal the plain chain's on the card")


def hold_join_probe(args, what: str) -> None:
    """The join probe's kernel against the reference's chains on the card,
    on the arguments (widened keys, probe_kv, table, T) a probe gave it:
    (start, len) bit for bit against _probe_ranges_dense on every row and
    against _probe_ranges_hot on the rows in probe_kv."""
    from gandiva_tpu_torch.ops import hash_join as hj
    from gandiva_tpu_torch.ops.kernels.join_probe import probe_ranges_cuda

    pk64, kv, table, T = args
    nb = table.shape[0] - T
    start, ln = probe_ranges_cuda(pk64, kv, table, T)
    d_start, d_ln, _ = hj._probe_ranges_dense(table, nb, pk64, kv)
    if not (torch.equal(start, d_start) and torch.equal(ln, d_ln)):
        raise AssertionError(f"join probe {what}: the kernel's (start, len) "
                             "differ from the dense chain's")
    if pk64.shape[0]:
        h_start, h_ln, _ = hj._probe_ranges_hot(table, nb, pk64, kv, 128)
        if not (torch.equal(start[kv], h_start[kv])
                and torch.equal(ln[kv], h_ln[kv])):
            raise AssertionError(f"join probe {what}: the kernel's (start, "
                                 "len) differ from the hot-key chain's")
    log(f"{what}: the join probe's (start, len) ({pk64.shape[0]} rows, "
        f"{int(kv.sum())} valid, {int((ln > 0).sum())} matched, {nb} build "
        f"rows in {table.shape[0]} slots) equal the dense chain's, and the "
        f"hot-key chain's on the valid rows, on the card")


def drive_configs4(gt, dev, smi: str):
    """BASELINE configs[4] as TPC-H SF10 ORDERS ⋈ CUSTOMER grouped by market
    segment, through ``run_pipeline_with_retry`` over ``make_mesh(4)`` on
    the one card with the reference's factors, uniform and then Zipf(1.3)
    o_custkey: exact against pyarrow.acero, rows/s (best of 3 synchronized
    walls), the pipeline's metrics, peak memory, host syncs a call, hot
    keys, partition balance, the profiler's top 8 and busy share, and each
    kernel's launches in the first (uniform) call. In each run, the join
    probe's kernel, K4 with K3's rounds, K5 and the join build's kernels
    are held against their plain versions on the inputs of their largest
    call in one more pipeline call. Returns the first call's launches and
    each kernel's largest difference."""
    from gandiva_tpu_torch import parallel
    from gandiva_tpu_torch.ops.kernels import LAUNCHES, reset_launches

    mesh = parallel.make_mesh(PIPE_PARTITIONS, device=dev)
    launches, report = None, {}
    errs = {"join_probe": 0.0, "sort": 0.0, "aggregate": 0.0,
            "join_build": 0.0}
    for name, zipf in (("uniform", False), ("zipf", True)):
        tables = orders_customer(dev, 22 + zipf, zipf)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        if launches is None:
            reset_launches()
        keys, sums, counts, metrics = parallel.run_pipeline_with_retry(
            mesh, *tables, filter_threshold=PIPE_THRESHOLD)
        if launches is None:
            launches = {k: LAUNCHES[k] for k in LAUNCHES}
        peak = torch.cuda.max_memory_allocated()
        walls = [metrics["wall_time_s"]]
        for _ in range(2):
            walls.append(parallel.run_pipeline_with_retry(
                mesh, *tables, filter_threshold=PIPE_THRESHOLD)[3][
                    "wall_time_s"])
        want_seg, want_sum, want_count, joined = acero_configs4(tables)
        if not (np.array_equal(keys, want_seg)
                and np.array_equal(sums, want_sum)
                and np.array_equal(counts, want_count)
                and metrics["join_out"] == joined):
            raise AssertionError(f"configs[4] {name}: differs from acero: "
                                 f"{keys, sums, counts} against "
                                 f"{want_seg, want_sum, want_count}")
        fn = parallel.build_filter_join_agg_sort(
            mesh, num_groups=metrics["num_groups"],
            hot_capacity=metrics["hot_capacity"],
            filter_threshold=PIPE_THRESHOLD)
        syncs = count_syncs(lambda: parallel.run_pipeline(fn, *tables, mesh))
        # partition balance: the joined rows each partition received, the
        # largest over the mean; this call also keeps the kernels' inputs
        with keep_largest_inputs({}) as kept:
            per = [int(x) for x in fn(*(parallel.shard(mesh, x)
                                        for x in tables))[5]["join_out"]]
        balance = max(per) * len(per) / max(sum(per), 1)
        for k, e in hold_kept_kernels(
                kept, f"configs[4] {name}",
                ("join_probe", "sort_block", "aggregate",
                 "join_build")).items():
            errs[k] = max(errs[k], e)
        del kept
        busy, _ = profile_call(
            lambda: parallel.run_pipeline(fn, *tables, mesh), top=8)
        ok = parallel.shard(mesh, tables[0])
        keep = [a > PIPE_THRESHOLD
                for a in parallel.shard(mesh, tables[1])]
        _, hot_valid = parallel.detect_hot_keys(ok, keep, mesh, 64)
        n_hot = int(hot_valid.sum())
        if zipf and n_hot < 1:
            raise AssertionError("configs[4] zipf: no hot key found")
        rows_s = ORDERS_SF10 / min(walls)
        log(f"configs[4] {name} ({smi}): {rows_s:.6g} rows/s, walls_s="
            f"{[round(w, 6) for w in walls]}; {len(keys)} groups exact "
            f"against pyarrow.acero; metrics {json.dumps(metrics)}; "
            f"max_memory_allocated={peak} (the path's own {peak - before}; "
            "reckoned 15-25 GB from the capacities); host syncs a call "
            f"{syncs}; hot keys {n_hot}; joined rows by partition {per} "
            f"(largest / mean {balance:.4f})")
        report[name] = {"rows_per_s": rows_s, "walls_s": walls,
                        "metrics": metrics, "max_memory_allocated": peak,
                        "own_memory": peak - before, "syncs": syncs,
                        "hot_keys": n_hot, "join_out_by_partition": per,
                        "device_busy_share": busy,
                        "balance": balance}
        del tables, ok, keep
    if min(launches[k] for k in ("sort_block", "merge_path",
                                 "aggregate", "join_build",
                                 "join_probe")) == 0:
        raise AssertionError(f"configs[4]: launches {launches}")
    log(f"configs[4] launches in one call: {launches}")
    log(json.dumps({"configs4": {
        "card": smi, "orders": ORDERS_SF10, "customers": CUSTOMER_SF10,
        "partitions": PIPE_PARTITIONS, "cards": mesh.num_cards,
        "launches": launches, "max_abs_err": errs, **report}}))
    return launches, errs


# -- phase 23: distributed_step over configs[0]'s inputs ---------------------

def drive_distributed_step(gt, dev, smi: str):
    """``entrypoints.distributed_step`` on one configs[0] batch of 64Mi rows
    made on the card (``a`` int64 in [0, 1000) with 5% nulls, ``b`` f64) as
    4 partitions, 1024 groups, a shuffle capacity of the rows a
    partition: held against pyarrow's group_by on the filtered rows (f64
    sums at rtol AGG_RTOL), rows/s (best of 3), launches, syncs; K1 and K5
    held against their plain versions on their largest call's inputs in
    one more call. Returns the first call's launches and each kernel's
    largest difference."""
    import pyarrow as pa

    from gandiva_tpu_torch import parallel
    from gandiva_tpu_torch.entrypoints import distributed_step
    from gandiva_tpu_torch.ops.kernels import LAUNCHES, reset_launches

    g = torch.Generator(device=dev)
    g.manual_seed(23)
    a = torch.randint(0, 1000, (N_STEP,), generator=g, device=dev)
    b = torch.rand(N_STEP, generator=g, dtype=torch.float64, device=dev)
    valid = torch.rand(N_STEP, generator=g, device=dev) >= 0.05
    mesh = parallel.make_mesh(STEP_PARTITIONS, device=dev)
    per = N_STEP // STEP_PARTITIONS
    fn = distributed_step(mesh, per, num_groups=STEP_GROUPS)
    args = [parallel.shard(mesh, x) for x in (a, b, valid)]
    torch.cuda.synchronize()
    reset_launches()
    keys, sums, counts, gcounts, total, overflow = fn(*args)
    torch.cuda.synchronize()
    launches = {k: LAUNCHES[k] for k in LAUNCHES}
    walls = []
    for _ in range(3):
        t = time.perf_counter()
        out = fn(*args)
        int(out[4])
        walls.append(time.perf_counter() - t)
    syncs = count_syncs(lambda: fn(*args))
    with keep_largest_inputs({}) as kept:
        fn(*args)
    errs = hold_kept_kernels(kept, "distributed_step",
                             ("compact", "aggregate"))
    del kept
    if bool(overflow):
        raise AssertionError("distributed_step: overflow")
    got = {}
    for p in range(mesh.local):
        c = int(gcounts[p])
        for k, s, n in zip(keys[p][:c].tolist(), sums[p][:c].tolist(),
                           counts[p][:c].tolist()):
            if k in got:
                raise AssertionError(f"key {k} on two partitions")
            got[k] = (s, n)
    keep = (valid & (a > 500)).cpu().numpy()
    ah, bh = a.cpu().numpy()[keep], b.cpu().numpy()[keep]
    want = pa.table({"k": ah, "v": bh * 2.0 + ah.astype(np.float64)}) \
        .group_by("k").aggregate([("v", "sum"), ("v", "count")])
    wk = want.column("k").to_numpy()
    ws = want.column("v_sum").to_numpy()
    wc = want.column("v_count").to_numpy()
    if set(got) != set(wk.tolist()) or int(total) != int(keep.sum()):
        raise AssertionError("distributed_step: groups differ from pyarrow")
    gs = np.array([got[k][0] for k in wk.tolist()])
    gc = np.array([got[k][1] for k in wk.tolist()])
    if not np.array_equal(gc, wc):
        raise AssertionError("distributed_step: counts differ")
    np.testing.assert_allclose(gs, ws, rtol=AGG_RTOL, atol=0)
    err = float(np.abs(gs - ws).max())
    if min(launches["compact"], launches["aggregate"]) == 0:
        raise AssertionError(f"distributed_step: launches {launches}")
    rows_s = N_STEP / min(walls)
    log(f"distributed_step ({smi}): {rows_s:.6g} rows/s, walls_s="
        f"{[round(w, 6) for w in walls]}; {len(got)} groups, {int(total)} "
        f"rows, equal to pyarrow (sums max abs err {err:.3g}); launches "
        f"{launches}; host syncs a call {syncs}")
    log(json.dumps({"distributed_step": {
        "card": smi, "rows": N_STEP, "partitions": STEP_PARTITIONS,
        "groups": len(got), "rows_per_s": rows_s, "walls_s": walls,
        "launches": launches, "syncs": syncs, "max_abs_err": err,
        "kernels_max_abs_err": errs}}))
    return launches, errs


# -- phase 24: profile in a fresh process ------------------------------------

PROFILE_CODE = """
import json, sys
import gandiva_tpu_torch as gt
from gandiva_tpu_torch.entrypoints import flagship_plan, flagship_stream
plan = flagship_plan("cuda")
_, make = flagship_stream("cuda")
cols = make(1, 1 << 20, seed=24)
batch = gt.Batch({n: gt.Column(d[0], v[0], t) for (n, (d, v)), t in zip(
    cols.items(), (gt.dtypes.int64, gt.dtypes.float64))}, 1 << 20)
print(json.dumps({"trace_dir": plan.profile(batch, trace_dir=sys.argv[1]),
                  "cost": plan.cost_analysis(batch)}))
"""


def profile_fresh_process(smi: str) -> dict:
    """The flagship plan's ``profile`` and ``cost_analysis`` in a fresh
    process (a long-lived one drops a call's first kernels, PERF.md §7):
    the Chrome trace must parse and name at least one CUDA kernel."""
    trace_dir = os.path.join(ROOT, "build", "profile_trace")
    r = subprocess.run([sys.executable, "-c", PROFILE_CODE, trace_dir],
                       cwd=ROOT, capture_output=True, text=True, timeout=300)
    if r.returncode:
        raise AssertionError(f"profile subprocess failed:\n{r.stderr[-3000:]}")
    out = json.loads(r.stdout.strip().splitlines()[-1])
    with open(os.path.join(out["trace_dir"], "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    kernels = sorted({e["name"] for e in events
                      if e.get("cat") == "kernel"})
    if not kernels:
        raise AssertionError("profile: the trace names no CUDA kernel")
    log(f"profile ({smi}): {len(events)} trace events, {len(kernels)} "
        f"distinct CUDA kernels, e.g. {kernels[:4]}; cost_analysis "
        f"{json.dumps(out['cost'])}")
    return {"events": len(events), "kernels": kernels, "cost": out["cost"]}


# -- phase 25: the scaling harnesses -----------------------------------------

def drive_scaling(dev, smi: str) -> dict:
    """``measure_scaling_efficiency`` and ``measure_weak_scaling`` over 1, 2
    and 4 partitions of the one card at a small size: they run on the card.
    Partitions of one card share it, so these rows measure no scaling
    efficiency."""
    from gandiva_tpu_torch import parallel

    strong = parallel.measure_scaling_efficiency(
        [1, 2, 4], SCALE_ROWS, SCALE_BUILD, device=dev)
    weak = parallel.measure_weak_scaling([1, 2, 4], WEAK_ROWS, WEAK_BUILD,
                                         device=dev)
    for r in strong + weak:
        if not (r["wall_s"] > 0 and r["n_cards"] == 1):
            raise AssertionError(f"scaling row {r}")
    log(f"scaling harnesses ({smi}; partitions of ONE card, so no scaling "
        f"efficiency is measured): strong {json.dumps(strong)}; weak "
        f"{json.dumps(weak)}")
    return {"strong": strong, "weak": weak}


# -- phase 26: the plan compiler ---------------------------------------------

EMIT_BATCHES = 16                # sources the emitter hold builds
INT_TYPES = ("int8", "int16", "int32", "int64", "uint8", "uint16", "uint32",
             "uint64")
FLOAT_HAZARDS = [np.nan, np.inf, -np.inf, 0.0, -0.0, 1.5, 2.5, -2.5,
                 0.49999999999999994, 2.0 ** 63, -2.0 ** 63, 2.0 ** 64,
                 -1e300, 1e300, 2.0 ** 31, 127.5, -128.5, 255.5, 65535.5,
                 -0.5, 4294967295.5, 9.2e18, -9.3e18, 1.8e19]


def eager_config(gt):
    """Configuration.optimize off: every node a torch call."""
    return gt.ConfigurationBuilder().with_optimize(False).build()


def emitter_signatures(gt):
    """(name, parameter type names, return type name) of every registry
    entry with an emitter (compiler/codegen.py) that names no string or
    binary type (but isnull / isnotnull), decimals at DEC_TYPES, every pair of them for the binary
    functions (the 256-bit multiply of two over 18 digits among them);
    castDECIMAL, whose return type is the tree's, to the first and the
    last of DEC_TYPES."""
    from gandiva_tpu_torch.registry import decimal_ops

    reg = gt.global_registry()
    decs = [gt.batch.parse_dtype(t) for t in DEC_TYPES]
    for a in decs:
        for b in decs:
            decimal_ops.ensure_registered([a, b])
    sigs = set()
    for f in list(reg._table.values()):
        params = tuple(map(str, f.signature.param_types))
        if f.emit is None or not {p for p in params
                                  if p.startswith("decimal")} <= set(
                                      DEC_TYPES):
            continue
        rt = f.signature.return_type
        if {"string", "binary"} & set(params + (str(rt),)) and \
                f.signature.name not in ("isnull", "isnotnull"):
            continue                        # string_emitter_plans'

        for ret in ((DEC_TYPES[0], DEC_TYPES[-1]) if rt is None
                    else (str(rt),)):
            sigs.add((f.signature.name, params, ret))
    return sorted(sigs)


def emitter_plans(gt):
    """The emitter signatures in EMIT_BATCHES Projectors' (schema,
    expressions): the arguments are columns x_<type>, y_<type>, but the
    decimal round's and truncate's scale, a literal (-1 .. 2)."""
    B, dt = gt.TreeExprBuilder, gt.dtypes
    sigs = emitter_signatures(gt)
    out = []
    for part in range(EMIT_BATCHES):
        batch_sigs = sigs[part::EMIT_BATCHES]
        types = sorted({t for _, params, _ in batch_sigs for t in params})
        schema = dt.Schema([dt.Field(f"{side}_{t}", gt.batch.parse_dtype(t))
                            for t in types for side in "xy"])
        exprs = []
        for i, (name, params, ret) in enumerate(batch_sigs):
            args = [B.make_field(schema.field(f"{'xy'[j]}_{t}"))
                    for j, t in enumerate(params)]
            if params[:1] and params[0].startswith("decimal") \
                    and params[1:] == ("int32",):
                args[1] = B.make_int32_literal(i % 4 - 1)
            rt = gt.batch.parse_dtype(ret)
            exprs.append(B.make_expression(B.make_function(name, args, rt),
                                           dt.Field(f"o{i}", rt)))
        out.append((schema, exprs))
    return out


STRING_EMIT_BATCHES = 4          # sources the string emitter hold builds
CONCAT_NAMES = ("concat", "concatOperator", "||")


def string_emitter_plans(gt):
    """Every string and binary signature with an emitter (phase 20's
    cases, but the per-row castVARCHAR / castVARBINARY of a number or a
    decimal; concat of a column and a literal, since two columns stay
    eager) in STRING_EMIT_BATCHES Projectors: (schema, expressions, each
    column's (type, the case's name), the signatures). Case i reads
    columns c<i>_a0 (and c<i>_a1), output o<i>."""
    B, dt = gt.TreeExprBuilder, gt.dtypes
    cases = [c for c in string_cases(gt)
             if not (c[0] in ("castVARCHAR", "castVARBINARY")
                     and c[1][0] not in ("string", "binary"))]
    out = []
    for part in range(STRING_EMIT_BATCHES):
        fields, exprs, spec, sigs = [], [], {}, cases[part::STRING_EMIT_BATCHES]
        for i, (name, params, ret) in enumerate(sigs):
            two = name in STRING_TWO_COLUMNS and name not in CONCAT_NAMES
            types = ("string",) if name in ("chr", "space", "locate") \
                else params[:2 if two else 1]
            mine = []
            for j, t in enumerate(types):
                f = dt.Field(f"c{i}_a{j}", gt.batch.parse_dtype(t))
                spec[f.name] = (t, name)
                mine.append(f)
            fields += mine
            if name in CONCAT_NAMES:
                node = B.make_function(name, [B.make_field(mine[0]),
                                              B.make_string_literal("-x")],
                                       dt.string)
            else:
                node = string_expr(gt, name, params, ret, mine).root
            exprs.append(B.make_expression(node, dt.Field(f"o{i}",
                                                          node.dtype)))
        out.append((dt.Schema(fields), exprs, spec, sigs))
    return out


def hold_string_emitters(gt, dev) -> dict:
    """Every string and binary signature with an emitter compiled against
    the eager route on the card over N_REGISTRY rows, dictionaries of
    STRING_DICT values with REGISTRY_NULLS nulls, in STRING_EMIT_BATCHES
    Projectors of one generated kernel each, nothing eager: values,
    validities and a string output's dictionary by value equal."""
    from gandiva_tpu_torch.ops.kernels import LAUNCHES

    rng = np.random.default_rng(261)
    t0 = time.perf_counter()
    held = 0
    for schema, exprs, spec, _ in string_emitter_plans(gt):
        cols = {k: (t, *string_column(t, N_REGISTRY, rng, name))
                for k, (t, name) in spec.items()}
        batch = gt.from_columns_numpy(cols, N_REGISTRY, device=dev)
        comp = gt.make_projector(schema, exprs, use_cache=False, device=dev)
        eager = gt.make_projector(schema, exprs, config=eager_config(gt),
                                  use_cache=False, device=dev)
        if comp._program.count("eager") or comp._program.kernels != 1:
            raise AssertionError("a string emitter signature stayed eager")
        before = LAUNCHES["plan"]
        got = comp.evaluate_device(batch)
        if LAUNCHES["plan"] - before != 1:
            raise AssertionError("the string plan did not launch once")
        want = eager.evaluate_device(batch)
        for e in exprs:
            n = e.result_field.name
            w = gt_column_cpu(want.column(n))
            if not same_string_column(got.column(n), w):
                raise AssertionError(f"{e.root.to_string()[:120]}: "
                                     "compiled differs from eager")
            held += 1
    log(f"{held} string and binary signatures held, compiled against eager "
        f"on the card, at {N_REGISTRY} rows, dictionaries of {STRING_DICT} "
        f"values, {REGISTRY_NULLS:.0%} nulls, in {STRING_EMIT_BATCHES} "
        f"generated kernels reading their host tables; "
        f"{time.perf_counter() - t0:.1f}s")
    return {"signatures": held}


def emitter_column(t: str, side: str, n: int, rng):
    """``registry_column``'s values (full-range integers, 5% nulls) with
    hazard rows first, all valid: 0, ±1, MIN and MAX (MIN / -1), every
    shift amount from -2 to the width + 1 in the right operand; NaN, ±inf,
    ±0.0, halves and values past every integer range; a string column's
    codes over a three-value dictionary."""
    import pyarrow as pa

    if t in ("string", "binary"):
        valid = rng.random(n) >= REGISTRY_NULLS
        codes = np.where(valid, rng.integers(0, 3, n), 0).astype(np.int32)
        typ = pa.string() if t == "string" else pa.binary()
        return codes, valid, None, pa.array(["a", "bb", ""], type=typ)
    data, valid, hi = registry_column(t, n, rng, amount=False)
    if t in INT_TYPES:
        info = np.iinfo(np.dtype(t))
        w = info.bits
        vals = ([0, 1, -1, info.min, info.max, info.min, info.max, 5, -7,
                 info.min, 100, 3] + [info.max - k for k in range(w + 4)]
                if side == "x" else
                [0, 0, -1, -1, -1, 0, 1, 2, 3, info.max, info.min, -3]
                + list(range(-2, w + 2)))
        h = np.array([v % (1 << w) if info.min == 0 else v for v in vals],
                     dtype=np.dtype(t))
    elif t in ("float32", "float64"):
        with np.errstate(over="ignore"):
            h = np.array(FLOAT_HAZARDS[::1 if side == "x" else -1],
                         dtype=np.dtype(t))
    else:
        return data, valid, hi
    data[:len(h)] = h
    valid[:len(h)] = True
    return data, valid, hi


def columns_equal(got, want) -> tuple:
    """Two card columns: (equal, rows whose bits differ only as NaN
    payloads). Validity, data bits (NaN equal to NaN) and the high limb."""
    want = gt_column_cpu(want)
    if not same_column(got, want):
        return False, 0
    g, w = got.data.cpu(), want.data
    return True, int((bits(g) != bits(w)).sum()) if g.numel() else 0


def gt_column_cpu(c):
    import gandiva_tpu_torch as gt

    return gt.Column(c.data.cpu(), c.validity.cpu(), c.dtype,
                     extra=None if c.extra is None else c.extra.cpu(),
                     dictionary=c.dictionary)


def plan_sources(gt):
    """The generated sources of the entry points' plans and of the emitter
    holds' Projectors, made as Make makes them (for a parallel build)."""
    from gandiva_tpu_torch import entrypoints as e
    from gandiva_tpu_torch.compiler import codegen

    plans = [*e._flagship_plans("cpu"), e.flagship_plan("cpu")] + [
        make("cpu") for make in (e.tpch_q1_scan, e.tpch_q6_scan,
                                 e.tpch_q7_scan, e.tpch_q12_scan,
                                 e.tpch_q19_scan,
                                 e.tpch_q9_part_scan, e.tpch_q16_part_scan,
                                 e.tpch_q22_customer_scan)]
    progs = [codegen.generate(p._roots, p._mask_root) for p in plans]
    progs += [codegen.generate([x.root for x in exprs])
              for _, exprs in emitter_plans(gt)]
    progs += [codegen.generate([x.root for x in exprs])
              for _, exprs, _, _ in string_emitter_plans(gt)]
    return [p.source for p in progs if p.kernels]


def count_launches(fn) -> int:
    """What one call of ``fn`` launches on the card: the torch operations
    whose output lies on the card (kernels and copies; allocations, views
    and reads to the host left out) and the hand-written and generated
    kernels (``LAUNCHES``)."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    from gandiva_tpu_torch.ops.kernels import LAUNCHES

    skip = {"aten::empty", "aten::empty_like", "aten::empty_strided",
            "aten::_local_scalar_dense"}

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if not func.is_view and func._schema.name not in skip and any(
                    isinstance(t, torch.Tensor) and t.is_cuda
                    for t in tree_leaves(out)):
                Count.n += 1
            return out

    before = sum(LAUNCHES.values())
    torch.cuda.synchronize()
    with Count():
        fn()
    torch.cuda.synchronize()
    return Count.n + sum(LAUNCHES.values()) - before


def best_wall(fn, runs: int = 3) -> float:
    walls = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
    return min(walls)


def kernel_region(comp, eager, cols, length: int, bw: float,
                  batch=None) -> dict:
    """The compiled plan's generated kernel(s) alone (the library's
    launches recorded on one call and replayed), its bytes (each operand
    read or written once) and bound at ``bw``, beside the eager route's
    time for the same nodes (``_run`` with no finish: no compaction)."""
    lib = comp._library
    calls = []
    replay = lib.run

    def record(*a):
        calls.append(a)
        return replay(*a)

    def region(plan):
        return plan._run(cols, length, 0, finish=lambda ctx, outs: outs,
                         batch=batch)

    lib.run = record
    comp._bytes = {"plan bytes read": 0, "plan bytes written": 0}
    try:
        keep = region(comp)
    finally:
        del lib.run
        nbytes, comp._bytes = comp._bytes, None
    torch.cuda.synchronize()
    kernel_ms = time_ms(lambda: [replay(*a) for a in calls], iters=20)
    compiled_ms = time_ms(lambda: region(comp), iters=10)
    eager_ms = time_ms(lambda: region(eager), iters=5)
    del keep
    total = nbytes["plan bytes read"] + nbytes["plan bytes written"]
    return {"kernel_ms": kernel_ms, "kernels": len(calls),
            "compiled_region_ms": compiled_ms, "eager_region_ms": eager_ms,
            "bytes": total, "bound_ms": total / bw * 1e3, **nbytes}


def k1_on_plan(plan, batch, bw: float) -> dict:
    """K1 alone on the mask and payloads ``plan`` (a FilterProject) hands
    it over ``batch`` (one call's, recorded), timed with CUDA events beside
    its byte bound at ``bw`` (``compaction_bytes``)."""
    from gandiva_tpu_torch.compiler import projector

    calls = []
    real = projector.compact_best

    def record(*a, **k):
        calls.append((a, k))
        return real(*a, **k)

    projector.compact_best = record
    try:
        plan.evaluate_device(batch)
    finally:
        projector.compact_best = real
    (mask, payload), kw = calls[0]
    survivors = int(mask.sum())
    width = sum(p.element_size() for p in payload)
    ms = time_ms(lambda: real(mask, payload, **kw), iters=20)
    nbytes = compaction_bytes(mask.numel(), survivors, width)
    return {"k1_ms": ms, "k1_bound_ms": nbytes / bw * 1e3,
            "k1_bytes": nbytes, "survivors": survivors,
            "payload_bytes_a_row": width}


def hold_emitters(gt, dev) -> dict:
    """Every emitter signature compiled against the eager route on the
    card, over N_REGISTRY rows with nulls and hazard rows, in
    EMIT_BATCHES Projectors (one generated kernel each): values,
    validities and high limbs equal, floats by their bits with NaN equal
    to NaN (rows whose NaN payloads differ are counted)."""
    from gandiva_tpu_torch.ops.kernels import LAUNCHES

    rng = np.random.default_rng(26)
    t0 = time.perf_counter()
    held, nan_rows = 0, 0
    for schema, exprs in emitter_plans(gt):
        cols = {}
        for f in schema:
            t, side = str(f.dtype), f.name[0]
            cols[f.name] = (t, *emitter_column(t, side, N_REGISTRY, rng))
        batch = gt.from_columns_numpy(cols, N_REGISTRY, device=dev)
        comp = gt.make_projector(schema, exprs, use_cache=False, device=dev)
        eager = gt.make_projector(schema, exprs, config=eager_config(gt),
                                  use_cache=False, device=dev)
        if comp._program.count("eager") or comp._program.kernels != 1:
            raise AssertionError("an emitter signature stayed eager")
        before = LAUNCHES["plan"]
        got = comp.evaluate_device(batch)
        if LAUNCHES["plan"] - before != 1:
            raise AssertionError("the emitter plan did not launch once")
        want = eager.evaluate_device(batch)
        for e in exprs:
            n = e.result_field.name
            ok, nan = columns_equal(got.column(n), want.column(n))
            if not ok:
                raise AssertionError(f"{e.root.to_string()[:120]}: "
                                     "compiled differs from eager")
            nan_rows += nan
            held += 1
    log(f"{held} emitter signatures held, compiled against eager on the "
        f"card, at {N_REGISTRY} rows ({REGISTRY_NULLS:.0%} nulls, hazard "
        f"rows) in {EMIT_BATCHES} generated kernels; rows differing only "
        f"as NaN payloads: {nan_rows}; {time.perf_counter() - t0:.1f}s")
    return {"signatures": held, "nan_payload_rows": nan_rows}


def hold_scan(sel_out_c, sel_out_e, what: str) -> None:
    """A FilterProject's compiled outputs against its eager ones: count,
    indices and every output column on [:count], bit for bit (NaN equal
    to NaN), a string's dictionary the same object."""
    (sc, oc), (se, oe) = sel_out_c, sel_out_e
    c = int(se.count)
    if int(sc.count) != c or not torch.equal(sc.indices[:c], se.indices[:c]):
        raise AssertionError(f"{what}: selection differs from eager")
    for name in oe.columns:
        g, w = oc.column(name), oe.column(name)
        cut = [gt_column_cpu(type(g)(x.data[:c], x.validity[:c], x.dtype,
                                     extra=None if x.extra is None
                                     else x.extra[:c],
                                     dictionary=x.dictionary))
               for x in (g, w)]
        if not same_column(*cut) or g.dictionary is not w.dictionary:
            raise AssertionError(f"{what}: {name} differs from eager")


def make_times(gt, make, eager_cfg) -> dict:
    """Seconds to make the plans ``make()`` returns: cold (their libraries
    deleted and out of memory: one nvcc each), from the libraries on disk,
    from this process's memo, and eager (optimize off: nothing built)."""
    import unittest.mock

    from gandiva_tpu_torch.compiler import jit

    paths = [p._library.path for p in make() if p._library is not None]
    for path in paths:
        jit._MEMO.pop(path, None)
        path.unlink()
    times = {}
    for key in ("cold", "disk", "memo"):
        if key == "disk":
            for path in paths:
                jit._MEMO.pop(path, None)
        t = time.perf_counter()
        make()
        times[key] = time.perf_counter() - t
    with unittest.mock.patch.object(gt.ConfigurationBuilder, "_default",
                                    eager_cfg):
        t = time.perf_counter()
        make()
        times["eager"] = time.perf_counter() - t
    return times


def drive_plan_compiler(gt, dev, smi: str) -> dict:
    """The plan compiler on the card: every emitter signature, then
    configs[0]'s flagship_stream, TPC-H Q1, Q6, Q7, Q12, Q19 (SF10 LINEITEM),
    Q9, Q16 (SF10 PART) and distributed_step, each compiled against its
    eager route at full size, bit for bit; rows/s of both routes (best of
    3), the generated kernel's time beside its byte bound, the eager
    route's time for the same nodes, launches a call on each route, and
    cold (nothing built) and warm Make times. Returns {path: report} and
    the plan kernel's launches by path."""
    import unittest.mock

    from gandiva_tpu_torch import entrypoints as e, parallel
    from gandiva_tpu_torch.compiler import jit
    from gandiva_tpu_torch.ops.kernels import LAUNCHES, reset_launches

    emitters = hold_emitters(gt, dev)
    emitters["wide_multiply"] = sum(
        1 for name, params, _ in emitter_signatures(gt)
        if name == "multiply" and all(
            p.startswith("decimal") and int(p[11:].split(",")[0]) > 18
            for p in params))
    log(f"of which the 256-bit decimal multiply (both operands of 19-38 "
        f"digits): {emitters['wide_multiply']} signatures")
    emitters["strings"] = hold_string_emitters(gt, dev)
    bw = peak_bandwidth(torch.cuda.get_device_name(0))
    eager_cfg = eager_config(gt)

    def eager_of(plan):
        return gt.make_filter_project(plan.schema, plan.condition,
                                      plan.exprs, config=eager_cfg,
                                      use_cache=False, device=dev)

    report, by_path = {}, {}

    def routes(what, comp_call, eager_call, rows, region, make,
               kernel=True, plan=None):
        make_s = make_times(gt, make, eager_cfg)
        reset_launches()
        comp_call()
        by_path[f"phase 26 {what}"] = LAUNCHES["plan"]
        if bool(LAUNCHES["plan"]) != kernel:
            raise AssertionError(f"{what}: the generated kernel launched "
                                 f"{LAUNCHES['plan']} times")
        r = {"rows": rows,
             "compiled_rows_per_s": rows / best_wall(comp_call),
             "eager_rows_per_s": rows / best_wall(eager_call),
             "compiled_launches": count_launches(comp_call),
             "eager_launches": count_launches(eager_call)}
        if region is not None:
            r.update(region)
        if plan is not None:
            r["eager_nodes"] = plan._program.count("eager")
            r["compiled_nodes"] = plan._program.count("compiled")
            r["host_tables"] = sum(len(st.tables)
                                   for st in plan._program.stages)
        r["make_s"] = make_s
        report[what] = r
        if plan is not None:
            log(f"{what}: Program.count('eager') = {r['eager_nodes']}, "
                f"compiled nodes {r['compiled_nodes']}, host tables read in "
                f"the kernel {r['host_tables']}")
        log(f"{what} ({smi}): compiled {r['compiled_rows_per_s']:.6g} "
            f"rows/s, eager {r['eager_rows_per_s']:.6g} rows/s; launches a "
            f"call {r['compiled_launches']} / {r['eager_launches']}"
            + ("" if region is None else
               f"; generated kernel {region['kernel_ms']:.4f} ms "
               f"({region['kernels']} launch) against a {region['bytes']} B "
               f"bound of {region['bound_ms']:.4f} ms "
               f"({region['bound_ms'] / region['kernel_ms']:.1%}); the same "
               f"nodes: compiled {region['compiled_region_ms']:.4f} ms, "
               f"eager {region['eager_region_ms']:.4f} ms")
            + f"; Make s {json.dumps(make_s)}")

    # configs[0]: flagship_stream, 4 batches of 64Mi rows
    fn_c, make_inputs = e.flagship_stream(dev)
    fp = e.flagship_plan(dev)
    fp_e = eager_of(fp)
    run_e = fp_e.stream_fn(e.flagship_checksum)

    def fn_e(cols):
        return torch.sum(run_e(cols))

    cols = make_inputs(STREAM_K, N_BIG, seed=26)
    for (ic, cc, pc), (ie, ce, pe) in zip(fp.stream_fn()(cols),
                                          fp_e.stream_fn()(cols)):
        hold((ic, pc, cc), (ie, pe, ce), "configs[0] compiled vs eager")
    if int(fn_c(cols)) != int(fn_e(cols)):
        raise AssertionError("configs[0]: checksums differ")
    first = {n: (d[0], v[0]) for n, (d, v) in cols.items()}
    routes("configs[0] flagship_stream", lambda: fn_c(cols),
           lambda: fn_e(cols), STREAM_K * N_BIG,
           kernel_region(fp, fp_e, first, N_BIG, bw),
           lambda: [e.flagship_plan(dev)])
    del cols, first

    # the LINEITEM scans at SF10
    n = e.LINEITEM_SF10_ROWS
    batch = e.lineitem(n, seed=26, device=dev)
    for q, make in (("Q1", e.tpch_q1_scan), ("Q6", e.tpch_q6_scan),
                    ("Q7", e.tpch_q7_scan), ("Q12", e.tpch_q12_scan),
                    ("Q19", e.tpch_q19_scan)):
        comp = make(dev)
        eag = eager_of(comp)
        hold_scan(comp.evaluate_device(batch), eag.evaluate_device(batch),
                  f"TPC-H {q}")
        routes(f"TPC-H {q} scan", lambda: comp.evaluate_device(batch),
               lambda: eag.evaluate_device(batch), n,
               kernel_region(comp, eag, comp._cols_of(batch), n, bw,
                             batch), lambda: [make(dev)], plan=comp)
        if q == "Q7":
            # the whole plan one generated kernel, then K1
            if comp._program.count("eager") or comp._program.kernels != 1:
                raise AssertionError("Q7: the plan is not one kernel")
            k1 = k1_on_plan(comp, batch, bw)
            report["TPC-H Q7 scan"].update(k1)
            log(f"Q7 ({smi}): K1 on its mask {k1['k1_ms']:.4f} ms against "
                f"a {k1['k1_bytes']} B bound of {k1['k1_bound_ms']:.4f} ms "
                f"({k1['k1_bound_ms'] / k1['k1_ms']:.1%}); "
                f"{k1['survivors']} survivors ({k1['survivors'] / n:.2%}), "
                f"{k1['payload_bytes_a_row']} B of payloads a survivor")
    del batch

    # the PART scans and Q22's CUSTOMER scan at SF10: their string nodes
    # read host tables in the one generated kernel
    part = e.part(e.PART_SF10_ROWS, seed=26, device=dev)
    cust = e.customer(e.CUSTOMER_SF10_ROWS, seed=26, device=dev)
    for q, make, b in (("Q9", e.tpch_q9_part_scan, part),
                       ("Q16", e.tpch_q16_part_scan, part),
                       ("Q22", e.tpch_q22_customer_scan, cust)):
        comp = make(dev)
        eag = eager_of(comp)
        if comp._program.count("eager") or comp._program.kernels != 1:
            raise AssertionError(f"{q}: the plan is not one kernel")
        hold_scan(comp.evaluate_device(b), eag.evaluate_device(b),
                  f"TPC-H {q}")
        region = kernel_region(comp, eag, comp._cols_of(b), b.length, bw, b)
        routes(f"TPC-H {q} {'customer' if b is cust else 'part'} scan",
               lambda: comp.evaluate_device(b),
               lambda: eag.evaluate_device(b), b.length, region,
               lambda: [make(dev)], plan=comp)
    del part, cust

    # distributed_step: one configs[0] batch as 4 partitions
    g = torch.Generator(device=dev)
    g.manual_seed(26)
    a = torch.randint(0, 1000, (N_STEP,), generator=g, device=dev)
    b = torch.rand(N_STEP, generator=g, dtype=torch.float64, device=dev)
    valid = torch.rand(N_STEP, generator=g, device=dev) >= 0.05
    mesh = parallel.make_mesh(STEP_PARTITIONS, device=dev)
    per = N_STEP // STEP_PARTITIONS
    step_c = e.distributed_step(mesh, per, num_groups=STEP_GROUPS)
    with unittest.mock.patch.object(gt.ConfigurationBuilder, "_default",
                                    eager_cfg):
        step_e = e.distributed_step(mesh, per, num_groups=STEP_GROUPS)
        filt_e, proj_e = e._flagship_plans(dev)
    filt_c, proj_c = e._flagship_plans(dev)
    args = [parallel.shard(mesh, x) for x in (a, b, valid)]
    for k, v, ok in zip(*args):
        cols = {"a": (k, ok), "b": (v, ok)}
        (ic, cc), (ie, ce) = (f._run(cols, per, 0) for f in (filt_c, filt_e))
        hold((ic, [], cc), (ie, [], ce), "distributed_step filter")
        pc, pe = (p._run_selected(cols, 0, ie, ce) for p in (proj_c, proj_e))
        c = int(ce)
        for (vc, mc), (ve, me) in zip(pc, pe):
            if not (torch.equal(bits(vc[:c]), bits(ve[:c]))
                    and torch.equal(mc[:c], me[:c])):
                raise AssertionError("distributed_step: projection differs")
    oc, oe = step_c(*args), step_e(*args)
    for p in range(mesh.local):             # groups by key, sums at rtol
        c = int(oe[3][p])
        if int(oc[3][p]) != c:
            raise AssertionError("distributed_step: group counts differ")
        (kc, sc, nc), (ke, se, ne) = (
            [x[p][:c][torch.argsort(o[0][p][:c])] for x in o[:3]]
            for o in (oc, oe))
        if not (torch.equal(kc, ke) and torch.equal(nc, ne) and
                torch.allclose(sc, se, rtol=AGG_RTOL, atol=0)):
            raise AssertionError("distributed_step: groups differ")
    if int(oc[4]) != int(oe[4]):
        raise AssertionError("distributed_step: row totals differ")
    routes("distributed_step", lambda: int(step_c(*args)[4]),
           lambda: int(step_e(*args)[4]), N_STEP, None,
           lambda: e._flagship_plans(dev))
    del a, b, valid, args

    log(json.dumps({"plan_compiler": {"card": smi, "emitters": emitters,
                                      **report}}))
    return report, by_path


# -- phase 27: the join build's kernels --------------------------------------

JOIN_CELL_BUILD = 4_502_048      # orders_customer_pipeline's build rows
JOIN_BUILD_ITERS = 10


def join_build_bytes(nb: int, runs: int) -> int:
    """Bytes the join build's two kernels must move over ``nb`` sorted keys
    that hold ``runs`` runs of one row: detection reads each key and writes
    its home word (16 B a row), reads each run's perm entry and writes its
    16-byte row (20 B a run); placement reads each run's sorted home word,
    order entry and row and writes the row into the table (44 B a run)."""
    return nb * 16 + runs * (20 + 44)


def drive_join_build(dev, bw: float, smi: str) -> dict:
    """The join build's two kernels (csrc/join_build.cu) on the builds of
    orders_customer_pipeline (4,502,048 rows, SF10's 1,500,000 customer
    keys valid and unique, the rest invalid, as the one partition's padded
    build holds them) and of configs[3]'s join_stream (arange(10,000,000)),
    each through build_join_table(how="inner"), so with perm: the table and
    all_unique held bit for bit against the plain chain on the card; then
    the two kernels' device time (torch.profiler), the kernel route's (the
    table's zeros and the sort of the home slots included), the plain
    chain's, and torch.cummin (int32) + torch.cummax (int64) over as many
    rows, the library scans the kernels replace, all beside the kernels'
    byte bound. Returns the times by build."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from gandiva_tpu_torch.ops import hash_join as hj
    from gandiva_tpu_torch.ops.kernels.join_build import build_ranges_cuda

    g = torch.Generator(device=dev)
    g.manual_seed(27)
    report = {}
    for label, nb, n_valid in (
            ("orders_customer_pipeline", JOIN_CELL_BUILD, CUSTOMER_SF10),
            ("configs[3] join_stream", JOIN_FULL_BUILD, JOIN_FULL_BUILD)):
        keys = torch.zeros(nb, dtype=torch.int64, device=dev)
        valid = torch.zeros(nb, dtype=torch.bool, device=dev)
        rows = torch.randperm(nb, generator=g, device=dev)[:n_valid]
        keys[rows] = torch.arange(1, n_valid + 1, device=dev)
        valid[rows] = True
        with keep_largest_inputs({}) as kept:
            hj.build_join_table(keys, build_valid=valid, how="inner")
        args = kept["join_build"]
        hold_join_build(args, label)
        sk64, nv, perm, T = args

        def route():
            return build_ranges_cuda(sk64, nv, perm, T)

        route()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(JOIN_BUILD_ITERS):
                route()
            torch.cuda.synchronize()
        us = {"detect_kernel": 0.0, "place_kernel": 0.0}
        for e in prof.events():
            for name in us:
                if e.device_type == DeviceType.CUDA and name in e.name:
                    us[name] += e.time_range.elapsed_us()
        start_pos = torch.arange(nb, dtype=torch.int32, device=dev)
        spread = torch.arange(nb, dtype=torch.int64, device=dev)
        t = {"rows": nb, "valid": n_valid, "slots": T + nb,
             # None where the profiler saw no device time (not measured)
             "detect_ms": us["detect_kernel"] / JOIN_BUILD_ITERS / 1e3
             if us["detect_kernel"] else None,
             "place_ms": us["place_kernel"] / JOIN_BUILD_ITERS / 1e3
             if us["place_kernel"] else None,
             "route_ms": time_ms(route, iters=JOIN_BUILD_ITERS),
             "plain_ms": time_ms(lambda: hj._build_ranges_plain(
                 sk64, nv, perm, T), iters=3, warmup=1),
             "cummin_ms": time_ms(lambda: torch.cummin(start_pos, 0),
                                  iters=3, warmup=1),
             "cummax_ms": time_ms(lambda: torch.cummax(spread, 0),
                                  iters=3, warmup=1),
             "bytes": join_build_bytes(nb, n_valid)}
        t["ms"] = (t["detect_ms"] + t["place_ms"]
                   if t["detect_ms"] and t["place_ms"] else None)
        t["library_ms"] = t["cummin_ms"] + t["cummax_ms"]
        t["bound_ms"] = t["bytes"] / bw * 1e3
        ms = "not measured" if t["ms"] is None else f"{t['ms']:.4f} ms"
        log(f"{label} ({smi}): the two kernels {ms} (detection "
            f"{t['detect_ms']}, placement {t['place_ms']}), the kernel "
            f"route {t['route_ms']:.4f} ms, the plain chain "
            f"{t['plain_ms']:.4f} ms, torch.cummin + torch.cummax "
            f"{t['library_ms']:.4f} ms; bound {t['bound_ms']:.4f} ms")
        report[label] = t
        del keys, valid, rows, kept, args, sk64, nv, perm, start_pos, spread
    log(json.dumps({"join_build": {"card": smi, **report}}))
    return report


# -- phase 28: the join probe's kernel ----------------------------------------

JOIN_CELL_PROBE = 7_500_000      # orders_customer_pipeline's probe, ≈ 50%
CUSTOMER_SF300 = 45_000_000      # SF × 150,000
JOIN_4CHIP_PROBE = 56_250_000    # orders_customer_4chip's probe a card
JOIN_PROBE_ITERS = 20


def join_probe_bytes(rows: int, valid: int, slots: int = 0) -> int:
    """Bytes the join probe must move: each row's int64 key, its validity
    byte and its int32 start and len (17 B), and 16 B a slot its valid
    rows read; with ``slots`` 0, one slot a valid row (its home)."""
    return rows * 17 + (slots or valid) * 16


def chain_reads(table, pk64, kv, T: int) -> int:
    """The slots the valid rows read along their chains, the home slot
    included, a round of the reference's walk at a time."""
    from gandiva_tpu_torch.ops import hash_join as hj
    from gandiva_tpu_torch.utils.hashing import hash32

    lo, hi = hj._limbs(pk64)
    pos = hash32(pk64) % T
    live = kv.clone()
    reads = 0
    while True:
        n = int(live.sum())
        if n == 0:
            return reads
        reads += n
        g = table.index_select(0, torch.where(live, pos, 0))
        live = live & (g[:, 3] > 0) & ~((g[:, 0] == lo) & (g[:, 1] == hi))
        pos = pos + 1


def drive_join_probe(dev, bw: float, smi: str) -> dict:
    """The join probe's kernel (csrc/join_probe.cu) at the probes of
    orders_customer_pipeline (7,500,000 uniform o_custkey rows against the
    one partition's padded build of 4,502,048 rows, SF10's 1,500,000
    customer keys valid) and of orders_customer_4chip on one card
    (56,250,000 rows against the card's 11,250,000 customer keys, every
    one with hash32 % 4 == 0, the homes of one rank), each table from
    build_join_table(how="inner") (T = 2^26 home slots both): (start, len)
    held bit for bit against the reference's dense and, on the valid rows,
    hot-key chains on the card; then the kernel's time (CUDA events) beside
    its byte bound (one slot a valid row) and the bytes of the slots its
    chains read, the two chains' times, one full-width 16-byte gather of the
    home slots (a round of their walks), and one probe_chunk's probe kernel
    launches and host syncs. Returns the times by probe."""
    from gandiva_tpu_torch.ops import hash_join as hj
    from gandiva_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from gandiva_tpu_torch.ops.kernels.join_probe import probe_ranges_cuda
    from gandiva_tpu_torch.utils.hashing import hash32

    g = torch.Generator(device=dev)
    g.manual_seed(28)
    report = {}
    for label in ("orders_customer_pipeline", "orders_customer_4chip card"):
        if label == "orders_customer_pipeline":
            nb, n = JOIN_CELL_BUILD, JOIN_CELL_PROBE
            keys = torch.zeros(nb, dtype=torch.int64, device=dev)
            valid = torch.zeros(nb, dtype=torch.bool, device=dev)
            rows = torch.randperm(nb, generator=g, device=dev)[:CUSTOMER_SF10]
            keys[rows] = torch.arange(1, CUSTOMER_SF10 + 1, device=dev)
            valid[rows] = True
            probe = torch.randint(1, CUSTOMER_SF10 + 1, (n,), generator=g,
                                  device=dev)
            del rows
        else:
            cand = torch.arange(1, CUSTOMER_SF300 + 1, device=dev)
            keys = cand[hash32(cand) % 4 == 0]
            nb, n = keys.shape[0], JOIN_4CHIP_PROBE
            valid = None
            probe = keys.index_select(0, torch.randint(
                0, nb, (n,), generator=g, device=dev))
            del cand
        jt = hj.build_join_table(keys, build_valid=valid, how="inner")
        T = jt.table.shape[0] - nb
        pk64 = hj._widen(hj.normalize_key(probe))
        kv = torch.ones(n, dtype=torch.bool, device=dev)
        hold_join_probe((pk64, kv, jt.table, T), label)
        reset_launches()
        hj.probe_chunk(jt, probe, None, "inner")
        torch.cuda.synchronize()
        launches = LAUNCHES["join_probe"]
        if launches != 1:
            raise AssertionError(f"{label}: probe_chunk launched the probe "
                                 f"kernel {launches} times")
        syncs = count_syncs(lambda: hj.probe_chunk(jt, probe, None, "inner"))
        home = hash32(pk64) % T
        reads = chain_reads(jt.table, pk64, kv, T)
        t = {"rows": n, "build_rows": nb, "slots": jt.table.shape[0],
             "T": T, "slot_reads": reads,
             "ms": time_ms(lambda: probe_ranges_cuda(pk64, kv, jt.table, T),
                           iters=JOIN_PROBE_ITERS),
             "dense_ms": time_ms(lambda: hj._probe_ranges_dense(
                 jt.table, nb, pk64, kv), iters=3, warmup=1),
             "hot_ms": time_ms(lambda: hj._probe_ranges_hot(
                 jt.table, nb, pk64, kv, 128), iters=3, warmup=1),
             "gather_ms": time_ms(lambda: jt.table.index_select(0, home),
                                  iters=5, warmup=1),
             "bytes": join_probe_bytes(n, n),
             "chain_bytes": join_probe_bytes(n, n, reads),
             "launches": launches, "probe_chunk_syncs": syncs}
        t["bound_ms"] = t["bytes"] / bw * 1e3
        t["chain_bound_ms"] = t["chain_bytes"] / bw * 1e3
        log(f"{label} ({smi}): {n} rows against {nb} build rows in "
            f"{t['slots']} slots (T {T}), {reads} slot reads "
            f"({reads / n:.4f} a row): the kernel {t['ms']:.4f} ms, bound "
            f"{t['bound_ms']:.4f} ms ({t['bound_ms'] / t['ms']:.1%}; with "
            f"every chain read {t['chain_bound_ms']:.4f} ms); the dense "
            f"chain {t['dense_ms']:.4f} ms, the hot-key chain "
            f"{t['hot_ms']:.4f} ms, one full-width gather of the home slots "
            f"{t['gather_ms']:.4f} ms; probe_chunk: {launches} probe "
            f"launch, {syncs} host syncs")
        report[label] = t
        del keys, valid, probe, jt, pk64, kv, home
        torch.cuda.empty_cache()
    log(json.dumps({"join_probe": {"card": smi, **report}}))
    return report


# -- phase 29: hot-key membership ------------------------------------------

ORDERS_SF300_CARD = 112_500_000  # orders_customer_4chip's probe keys a card
CUSTOMER_SF300_CARD = 11_250_000  # and its build keys
KEY_TABLE_ITERS = 20


def drive_key_table(dev, bw: float, smi: str) -> dict:
    """Hot-key membership (csrc/key_table.cu) at the skew join's two calls
    a query: orders_customer_pipeline's 15,000,000 probe and 1,500,000 build
    keys, and a card of orders_customer_4chip's 112,500,000 and 11,250,000,
    uniform over the customer keys, against a table of 64 entries (the
    pipeline's num_hot) all invalid (uniform o_custkey finds no hot key) and
    half valid. The flags are held bit for bit against the plain route on
    the card (_is_in_table_plain); then the kernel's time (CUDA events)
    beside its byte bound (9 B a key), the plain route's time (its host
    read of the table included) and torch.isin's alone on the masked
    table. Returns the times by size and table."""
    from gandiva_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    from gandiva_tpu_torch.ops.kernels.key_table import is_in_table_cuda
    from gandiva_tpu_torch.parallel.ops import _is_in_table, _is_in_table_plain

    g = torch.Generator(device=dev)
    g.manual_seed(29)
    report = {}
    for label, n, customers in (
            ("orders_customer_pipeline probe", ORDERS_SF10, CUSTOMER_SF10),
            ("orders_customer_pipeline build", CUSTOMER_SF10, CUSTOMER_SF10),
            ("orders_customer_4chip card probe", ORDERS_SF300_CARD,
             CUSTOMER_SF300),
            ("orders_customer_4chip card build", CUSTOMER_SF300_CARD,
             CUSTOMER_SF300)):
        keys = torch.randint(1, customers + 1, (n,), generator=g, device=dev)
        table = torch.randint(1, customers + 1, (64,), generator=g,
                              device=dev)
        for tv in ("all invalid", "half valid"):
            valid = torch.arange(64, device=dev) < (0 if tv == "all invalid"
                                                    else 32)
            reset_launches()
            got = _is_in_table(keys, table, valid)
            want = _is_in_table_plain(keys, table, valid)
            torch.cuda.synchronize()
            if LAUNCHES["key_table"] != 1:
                raise AssertionError(f"key table {label}, {tv}: "
                                     f"_is_in_table launched the kernel "
                                     f"{LAUNCHES['key_table']} times")
            if not torch.equal(got, want):
                raise AssertionError(f"key table {label}, {tv}: the "
                                     f"kernel's flags differ from the plain "
                                     f"route's")
            members = int(got.sum())
            masked = torch.where(valid, table,
                                 table[int(torch.argmax(valid.int()))])
            t = {"keys": n, "entries": 64, "valid": int(valid.sum()),
                 "members": members,
                 "ms": time_ms(lambda: is_in_table_cuda(keys, table, valid),
                               iters=KEY_TABLE_ITERS),
                 "plain_ms": time_ms(lambda: _is_in_table_plain(
                     keys, table, valid), iters=3, warmup=1),
                 "isin_ms": time_ms(lambda: torch.isin(keys, masked),
                                    iters=3, warmup=1),
                 "bytes": 9 * n}
            t["bound_ms"] = t["bytes"] / bw * 1e3
            log(f"key table {label}, {tv} ({smi}): {n} keys, {members} "
                f"members: the kernel {t['ms']:.4f} ms, bound "
                f"{t['bound_ms']:.4f} ms ({t['bound_ms'] / t['ms']:.1%}); "
                f"the plain route {t['plain_ms']:.4f} ms, torch.isin "
                f"{t['isin_ms']:.4f} ms")
            report[f"{label}, {tv}"] = t
            del got, want, masked
        del keys, table
        torch.cuda.empty_cache()
    log(json.dumps({"key_table": {"card": smi, **report}}))
    return report


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import pyarrow as pa
    import pyarrow.compute as pc

    import gandiva_tpu_torch as gt
    from gandiva_tpu_torch.entrypoints import (_flagship_plans,
                                               flagship_checksum,
                                               flagship_plan, flagship_stream)
    from gandiva_tpu_torch.ops.kernels import LAUNCHES, build, reset_launches
    from gandiva_tpu_torch.ops.kernels.compaction import (
        MAX_PAYLOADS, compact_columns_cuda, compact_columns_plain)
    from gandiva_tpu_torch.ops.kernels import aggregate as k5
    from gandiva_tpu_torch.ops.hash_aggregate import _kernel_column

    dev = torch.device("cuda")

    # -- 1. device -------------------------------------------------------
    phase("device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; device 0: "
        f"{kind}; device count {count}")
    bw = peak_bandwidth(kind)

    # -- 2. build --------------------------------------------------------
    phase("build")
    t = time.perf_counter()
    from concurrent.futures import ThreadPoolExecutor

    from gandiva_tpu_torch.compiler import jit
    sources = plan_sources(gt)
    with ThreadPoolExecutor(1) as pool:     # the plans' nvccs meanwhile
        plans_built = pool.submit(jit.build_all, sources)
        build_logs = build.build_all()
        plans_built.result()
    log(f"{len(sources)} generated plan sources built (the entry points' "
        f"plans and phase 26's emitter Projectors)")
    for name, text in build_logs.items():
        log(f"-- csrc/{name}.cu")
        for line in ptxas_lines(text):
            log("   " + line)
    log(f"build {time.perf_counter() - t:.1f}s")

    # -- 3. kernel against plain -----------------------------------------
    phase("K1 against its plain version")
    g = torch.Generator(device=dev)
    g.manual_seed(7)
    u = torch.rand(N_BIG, generator=g, device=dev)
    f64 = torch.rand(N_BIG, generator=g, dtype=torch.float64, device=dev)
    vb = torch.rand(N_BIG, generator=g, device=dev) < 0.5
    max_err = 0.0
    for d in DENSITIES:
        mask = u < d
        got = compact_columns_cuda(mask, [f64, vb])
        torch.cuda.synchronize()
        want = compact_columns_plain(mask, [f64, vb])
        torch.cuda.synchronize()
        max_err = max(max_err, hold(got, want, f"n={N_BIG} density={d}"))
        log(f"n={N_BIG} density={d}: count={int(got[2])} matches plain")
    del got, want
    mask_r = torch.rand(N_RAGGED, generator=g, device=dev) < 0.43
    ragged = [torch.randint(-10**12, 10**12, (N_RAGGED,), generator=g,
                            dtype=torch.int64, device=dev),
              torch.rand(N_RAGGED, generator=g, device=dev),
              torch.randint(-2**31, 2**31 - 1, (N_RAGGED,), generator=g,
                            dtype=torch.int32, device=dev),
              torch.rand(N_RAGGED, generator=g, device=dev) < 0.5]
    got = compact_columns_cuda(mask_r, ragged)
    torch.cuda.synchronize()
    want = compact_columns_plain(mask_r, ragged)
    torch.cuda.synchronize()
    max_err = max(max_err, hold(got, want, f"ragged n={N_RAGGED}"))
    log(f"ragged n={N_RAGGED}: count={int(got[2])} matches plain "
        f"(int64, float32, int32, bool)")
    # more payloads than one scatter launch moves: two launches
    many = ragged + [c.flip(0) for c in ragged] + ragged[:2]
    before = LAUNCHES["compact"]
    got = compact_columns_cuda(mask_r, many)
    torch.cuda.synchronize()
    launched = LAUNCHES["compact"] - before
    want = compact_columns_plain(mask_r, many)
    torch.cuda.synchronize()
    max_err = max(max_err, hold(got, want, f"ragged n={N_RAGGED}, "
                                f"{len(many)} payloads"))
    if launched != -(-len(many) // MAX_PAYLOADS):
        raise AssertionError(f"{len(many)} payloads took {launched} scatter "
                             "launches")
    log(f"ragged n={N_RAGGED}, {len(many)} payloads: matches plain "
        f"({launched} scatter launches)")
    # views at an offset: neither the mask nor the 1- and 2-byte payloads
    # are 16-B aligned (the scatter's byte and element paths; 8 leaves the
    # 2-byte column aligned), held against plain and K2
    from gandiva_tpu_torch.ops.kernels import compaction_fragnet as k2
    for off in (1, 3, 8):
        mask_v = mask_r[off:]
        views = [c[off:] for c in ragged]
        got = compact_columns_cuda(mask_v, views)
        torch.cuda.synchronize()
        max_err = max(max_err, hold(got, compact_columns_plain(mask_v, views),
                                    f"K1 views at offset {off}"))
        hold(got, k2.compact_fragnet_cuda(mask_v, views),
             f"K1 views at offset {off} (K2)")
        log(f"views at offset {off}: count={int(got[2])} matches plain and "
            "K2")
    # no payload: Filter.evaluate's indices only
    for n in (N_BIG, 4 * 4096 - 1, 4 * 4096, 4 * 4096 + 1, N_RAGGED):
        m = u[:n] < FLAGSHIP_DENSITY
        got = compact_columns_cuda(m, [])
        torch.cuda.synchronize()
        hold(got, compact_columns_plain(m, []), f"K1 indices only n={n}")
        log(f"indices only n={n}: count={int(got[2])} matches plain")
    del got, want, ragged, many, mask_v, views, m

    # -- 4. kernel times -------------------------------------------------
    phase("K1 times")
    mask = u < FLAGSHIP_DENSITY
    survivors = int(mask.sum())
    pay = [f64, vb]

    def library():
        sel = torch.nonzero(mask).flatten()
        return [p.index_select(0, sel) for p in pay]

    kernel_ms = time_ms(lambda: compact_columns_cuda(mask, pay), iters=50)
    plain_ms = time_ms(lambda: compact_columns_plain(mask, pay), iters=20)
    library_ms = time_ms(library, iters=20)
    kernel_ms2 = time_ms(lambda: compact_columns_cuda(mask, pay), iters=50)
    nbytes = compaction_bytes(N_BIG, survivors, 8 + 1)
    bound_ms = nbytes / bw * 1e3
    log(f"n={N_BIG} survivors={survivors} bytes={nbytes}")
    log(f"kernel_ms={kernel_ms:.4f} (again {kernel_ms2:.4f}) "
        f"plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} "
        f"bound_ms={bound_ms:.4f} at {bw / 1e12:.2f} TB/s "
        f"-> {bound_ms / kernel_ms:.1%} of the bound")
    from gandiva_tpu_torch.ops.kernels import compaction as k1
    log("K1's build (-Xptxas -v):")
    for line in ptxas_lines(build_logs["compaction"]):
        log("   " + line)
    k1_shapes = {}
    for what, d, cols in (("density 0.02", 0.02, pay),
                          ("density 0.474", FLAGSHIP_DENSITY, pay),
                          ("density 0.97", 0.97, pay),
                          ("indices only, density 0.474", FLAGSHIP_DENSITY,
                           [])):
        m = u < d
        counts = k1.tile_counts(m)
        widths = [c.element_size() for c in cols]
        kept = int(m.sum())
        grid, stages, smem = k1.scatter_shape(cols)
        r = {"survivors": kept,
             "ms": time_ms(lambda: compact_columns_cuda(m, cols), iters=50),
             "count_ms": time_ms(lambda: k1.tile_counts(m), iters=50),
             "scatter_ms": time_ms(lambda: k1.scatter(m, counts, cols),
                                   iters=50),
             "cumsum_ms": time_ms(lambda: torch.cumsum(
                 counts, 0, dtype=torch.int32), iters=50),
             "bytes": compaction_bytes(N_BIG, kept, sum(widths)),
             "sector_bytes": sector_bytes(m, widths)}
        r.update({"bound_ms": r["bytes"] / bw * 1e3,
                  "sector_bytes_ms": r["sector_bytes"] / bw * 1e3,
                  "scatter_grid": grid, "scatter_stages": stages,
                  "scatter_smem": smem})
        k1_shapes[what] = r
        log(f"K1 {what}: {r['ms']:.4f} ms (count pass {r['count_ms']:.4f}, "
            f"scatter {r['scatter_ms']:.4f}; a torch.cumsum of the counts "
            f"would add {r['cumsum_ms']:.4f}); bound {r['bound_ms']:.4f} ms "
            f"({r['bound_ms'] / r['ms']:.1%}), sector bytes "
            f"{r['sector_bytes_ms']:.4f} ms; scatter grid {grid} CTAs, "
            f"{stages} stages, {smem} B of shared memory")
    log(json.dumps({"k1_shapes": k1_shapes}))
    del u, f64, vb, mask, pay, m, counts

    # -- 5. main path, Arrow entry point ---------------------------------
    phase("main path: Arrow entry point")
    reset_launches()
    rng = np.random.default_rng(42)       # bench_reference/bench_arrow.py
    a = rng.integers(0, 1000, ARROW_ROWS)
    b = rng.random(ARROW_ROWS)
    nulls = rng.random(ARROW_ROWS) < 0.05
    batch = pa.RecordBatch.from_arrays(
        [pa.array(a, mask=nulls), pa.array(b)], names=["a", "b"])
    filt, proj = _flagship_plans(dev)
    fp = gt.make_filter_project(filt.schema, filt.condition, proj.exprs,
                                device=dev)
    sel, (out,) = fp.evaluate(batch)
    keep = pc.fill_null(pc.greater(batch.column("a"), pa.scalar(500)), False)
    exp_idx = np.nonzero(np.asarray(keep))[0]
    expected = pc.take(
        pc.add(pc.multiply(batch.column("b"), pa.scalar(2.0)),
               pc.cast(batch.column("a"), pa.float64())), pa.array(exp_idx))
    if not np.array_equal(sel.to_numpy(), exp_idx) or not out.equals(expected):
        raise AssertionError("FilterProject disagrees with pyarrow.compute")
    dev_batch = gt.from_arrow(batch, device=dev)
    sel1 = gt.make_filter(filt.schema, filt.condition,
                          device=dev).evaluate(dev_batch)
    (out1,) = gt.make_projector(filt.schema, proj.exprs,
                                gt.SelectionMode.UINT32,
                                device=dev).evaluate(dev_batch, selection=sel1)
    if not np.array_equal(sel1.to_numpy(), exp_idx) or not out1.equals(out):
        raise AssertionError("Filter + Projector(selection) != FilterProject")
    arrow_launches = LAUNCHES["compact"]
    arrow_plan_launches = LAUNCHES["plan"]
    log(f"{ARROW_ROWS} rows: {len(exp_idx)} selected, equal to "
        f"pyarrow.compute; Filter + Projector(selection) equal to fused; "
        f"K1 launches {arrow_launches}")

    # -- 6. main path, streaming at full size ----------------------------
    phase("main path: flagship_stream")
    fn, make_inputs = flagship_stream(dev)
    cols = make_inputs(STREAM_K, N_BIG, seed=42)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    fn(cols)                                   # warm-up (allocator)
    torch.cuda.synchronize()
    walls = []
    runs = 3
    for _ in range(runs):
        t = time.perf_counter()
        total = fn(cols)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
    stream_launches = LAUNCHES["compact"]
    stream_plan_launches = LAUNCHES["plan"]
    peak = torch.cuda.max_memory_allocated()
    rows_s = STREAM_K * N_BIG / min(walls)
    log(f"K={STREAM_K} n={N_BIG}: walls_s={[round(w, 6) for w in walls]} "
        f"rows/s={rows_s:.6g} checksum={int(total)} K1 launches "
        f"{stream_launches} (expected {(1 + runs) * STREAM_K}) "
        f"max_memory_allocated={peak}")
    if stream_launches != (1 + runs) * STREAM_K:
        raise AssertionError("the stream did not launch K1 once per batch")
    if stream_plan_launches != (1 + runs) * STREAM_K:
        raise AssertionError("the stream did not launch its generated "
                             "kernel once per batch")
    busy, _ = profile_call(lambda: fn(cols))

    plan = flagship_plan(dev)
    first = {name: (d[0], v[0]) for name, (d, v) in cols.items()}
    got = plan._run(first, N_BIG, 0)
    mask, payload = plan._run(first, N_BIG, 0, finish=plan._dense)
    want = compact_columns_plain(mask, payload)
    torch.cuda.synchronize()
    hold((got[0], got[2], got[1]), want, "stream batch 0")
    if int(flagship_checksum(*got)) != int(flagship_checksum(
            want[0], want[2], want[1])):
        raise AssertionError("batch 0 checksum differs from plain")
    per_batch = sum(int(flagship_checksum(*r))
                    for r in plan.stream_fn()(cols))
    if per_batch != int(total):
        raise AssertionError("flagship_stream checksum != sum of batches")
    log(f"batch 0: {int(got[1])} rows selected, bit-exact with the plain "
        f"compaction; checksum equal to the per-batch sum")
    del cols, got, want, mask, payload

    main_launches = arrow_launches + stream_launches
    k1_by_path = {"configs[0] Arrow entry point": arrow_launches,
                  "configs[0] flagship_stream": stream_launches}
    if main_launches == 0:
        raise AssertionError("the main path never launched K1")
    log(json.dumps({"main_path": {
        "stream_rows_per_s": rows_s, "stream_walls_s": walls,
        "batches": STREAM_K, "rows_per_batch": N_BIG,
        "max_memory_allocated": peak, "device_busy_share": busy,
        "k1_launches_arrow": arrow_launches,
        "k1_launches_stream": stream_launches}}))

    # -- 7. K5 against plain ---------------------------------------------
    phase("K5 against its plain version")
    g.manual_seed(11)
    agg_keys = torch.randint(0, AGG_GROUPS, (N_AGG,), generator=g,
                             device=dev) * 7 + 3           # bench.py:89
    agg_f64 = torch.rand(N_AGG, generator=g, dtype=torch.float64, device=dev)
    agg_i64 = torch.randint(-1000, 1000, (N_AGG,), generator=g, device=dev)
    k5_err = 0.0
    for label, vals in (("f64", agg_f64), ("int64", agg_i64)):
        cols = [_kernel_column(vals, None, True, True)]
        got = k5.aggregate_cuda(agg_keys, None, cols, AGG_GROUPS)
        torch.cuda.synchronize()
        want = k5.aggregate_plain(agg_keys, None, cols, AGG_GROUPS)
        torch.cuda.synchronize()
        k5_err = max(k5_err, hold_k5(got, want, [c.kind for c in cols],
                                     f"configs[1] {label}"))
        log(f"n={N_AGG} {label}: {int(got.count)} groups, matches plain")
    del got, want

    def ragged_columns(n):
        raw = [torch.randint(-128, 128, (n,), generator=g, device=dev
                             ).to(torch.int8),
               torch.randint(-2**31, 2**31, (n,), generator=g, device=dev
                             ).to(torch.int32),
               torch.randint(0, 2**32, (n,), generator=g, device=dev
                             ).to(torch.int32).view(torch.uint32),
               ((torch.randint(0, 2**32, (n,), generator=g, device=dev) << 32)
                | torch.randint(0, 2**32, (n,), generator=g, device=dev)
                ).view(torch.uint64),
               torch.rand(n, generator=g, device=dev) * 200 - 100,
               torch.randn(n, generator=g, dtype=torch.float64, device=dev)]
        return [_kernel_column(a, torch.rand(n, generator=g, device=dev)
                               >= 0.1, True, True) for a in raw]

    n = N_RAGGED
    u = torch.rand(n, generator=g, device=dev)
    code = torch.where(u < 0.1, 2, 1).to(torch.uint8)      # 10% null keys
    cols = ragged_columns(n)
    extreme = torch.tensor([-2**63, 2**63 - 1, 0, -1, 1], device=dev)
    cases = [
        ("64 groups", torch.randint(0, 64, (n,), generator=g, device=dev),
         code, cols, 64),
        ("1000 groups", torch.randint(0, 1000, (n,), generator=g,
                                      device=dev) * 7 + 3, code, cols, 1024),
        ("1100 keys", torch.randint(0, 1100, (n,), generator=g, device=dev),
         code, cols, 1024),
        ("count_all only", torch.randint(0, 64, (n,), generator=g,
                                         device=dev), code, [], 64),
        ("int64::min/max, 0", extreme[torch.randint(0, 5, (n,), generator=g,
                                                    device=dev)],
         None, cols[:2], 8)]
    for label, keys, code_, cols_, max_groups in cases:
        before = LAUNCHES["aggregate"]
        got = k5.aggregate_cuda(keys, code_, cols_, max_groups)
        torch.cuda.synchronize()
        launched = LAUNCHES["aggregate"] - before
        want = k5.aggregate_plain(keys, code_, cols_, max_groups)
        torch.cuda.synchronize()
        k5_err = max(k5_err, hold_k5(got, want, [c.kind for c in cols_],
                                     f"ragged {label}"))
        if launched != max(1, -(-len(cols_) // k5.MAX_VALUES)):
            raise AssertionError(f"ragged {label}: {launched} launches")
        log(f"ragged n={n} {label} (max_groups {max_groups}, "
            f"{len(cols_)} columns, {launched} launches): "
            f"{int(got.count)} groups, overflow {bool(got.overflow)}, "
            "matches plain")
    if not bool(got.overflow) and int(got.count) != 5:
        raise AssertionError("the extreme keys did not form 5 groups")
    # the redesign's shapes: one group (every lane of a warp-step its peer:
    # the pointer-jumping path) on the private variant, and the shapes at
    # gcap 1024 on the shared one: 1024 distinct keys with one column (a few
    # copies) and with 4 (one copy), and 2 keys (pointer jumping)
    k1024 = torch.randperm(n, generator=g, device=dev) % 1024 * 13 - 99
    variants = [
        ("one group", torch.full((n,), -42, dtype=torch.int64, device=dev),
         code, cols[:4], 8),
        ("1024 keys x 1 column", k1024, None, cols[5:], 1024),
        ("1024 keys x 4 columns", k1024, None, cols[2:], 1024),
        ("1024 keys x 4 columns, 10% null keys", k1024, code, cols[:4],
         1024),
        ("2 keys at gcap 1024", k1024 % 2, code, cols[4:], 1024)]
    k5_variants = {}
    for label, keys, code_, cols_, max_groups in variants:
        got = k5.aggregate_cuda(keys, code_, cols_, max_groups)
        torch.cuda.synchronize()
        want = k5.aggregate_plain(keys, code_, cols_, max_groups)
        torch.cuda.synchronize()
        k5_err = max(k5_err, hold_k5(got, want, [c.kind for c in cols_],
                                     label))
        copies, private = k5.accumulator_copies(
            k5.capacity_for(max_groups), min(len(cols_), k5.MAX_VALUES))
        k5_variants[label] = {"copies": copies, "private": private}
        log(f"{label} (n={keys.shape[0]}, max_groups {max_groups}): "
            f"{int(got.count)} groups, {copies} accumulator copies a CTA "
            f"({'private' if private else 'shared'} variant), "
            "matches plain")
    if not k5_variants["one group"]["private"] or any(
            v["private"] for k, v in k5_variants.items() if k != "one group"):
        raise AssertionError(f"K5 variants: {k5_variants}")
    del got, want, cols, cases, code, u, k1024, variants, keys

    # -- 8. K5 times -----------------------------------------------------
    phase("K5 times")
    agg_cols = [_kernel_column(agg_f64, None, True, True)]

    def agg_library():
        uniq, inv = torch.unique(agg_keys, sorted=True, return_inverse=True)
        groups = uniq.shape[0]
        cnt = torch.zeros(groups, dtype=torch.int64, device=dev).index_add_(
            0, inv, torch.ones_like(inv))
        tot = torch.zeros(groups, dtype=torch.float64, device=dev
                          ).index_add_(0, inv, agg_f64)
        lo = torch.full((groups,), float("inf"), dtype=torch.float64,
                        device=dev).scatter_reduce_(0, inv, agg_f64, "amin")
        hi = torch.full((groups,), float("-inf"), dtype=torch.float64,
                        device=dev).scatter_reduce_(0, inv, agg_f64, "amax")
        return cnt, tot, lo, hi

    k5_ms = time_ms(lambda: k5.aggregate_cuda(agg_keys, None, agg_cols,
                                              AGG_GROUPS), iters=20)
    k5_plain_ms = time_ms(lambda: k5.aggregate_plain(
        agg_keys, None, agg_cols, AGG_GROUPS), iters=5, warmup=1)
    k5_library_ms = time_ms(agg_library, iters=5, warmup=1)
    k5_ms2 = time_ms(lambda: k5.aggregate_cuda(agg_keys, None, agg_cols,
                                               AGG_GROUPS), iters=20)
    k5_i64_ms = time_ms(lambda: k5.aggregate_cuda(
        agg_keys, None, [_kernel_column(agg_i64, None, True, True)],
        AGG_GROUPS), iters=20)
    # where K5's time goes: the same rows with fewer atomics per row
    k5_parts = {label: time_ms(lambda c=c: k5.aggregate_cuda(
        agg_keys, None, c, AGG_GROUPS), iters=20) for label, c in (
            ("count_all only", []),
            ("f64 sum only", [_kernel_column(agg_f64, None, True, False)]),
            ("f64 min/max only", [_kernel_column(agg_f64, None, False,
                                                 True)]))}
    # least bytes: each input read once (8 B key + 8 B value per row), each
    # output written once (keys, meta, count_all, 4 accumulator rows)
    gcap = k5.capacity_for(AGG_GROUPS)
    k5_bytes = N_AGG * (8 + 8) + 8 * (gcap + 2 + (gcap + 2) * (1 + 4))
    k5_bound_ms = k5_bytes / bw * 1e3
    log(f"n={N_AGG} groups={AGG_GROUPS} bytes={k5_bytes}")
    log(f"k5_ms={k5_ms:.4f} (again {k5_ms2:.4f}; int64 values "
        f"{k5_i64_ms:.4f}) plain_ms={k5_plain_ms:.4f} "
        f"library_ms={k5_library_ms:.4f} bound_ms={k5_bound_ms:.4f} -> "
        f"{k5_bound_ms / k5_ms:.1%} of the bound")
    log("K5 by work per row: " + ", ".join(
        f"{label} {ms:.4f} ms" for label, ms in k5_parts.items()))
    # the largest shape the contract allows: 1024 groups, 4 distinct columns
    # (the shared variant), each input read once and the outputs written once
    k5_wide = {"rows": N_AGG, "groups": 1024, "columns": 4}
    wide_keys = torch.randint(0, 1024, (N_AGG,), generator=g, device=dev)
    wide_cols = [_kernel_column(agg_f64, None, True, True),
                 _kernel_column(agg_i64, None, True, True),
                 _kernel_column(torch.rand(N_AGG, generator=g,
                                           dtype=torch.float64, device=dev),
                                None, True, True),
                 _kernel_column(torch.randint(-1000, 1000, (N_AGG,),
                                              generator=g, device=dev),
                                None, True, True)]
    k5_wide["ms"] = time_ms(lambda: k5.aggregate_cuda(
        wide_keys, None, wide_cols, 1024), iters=5)
    k5_wide["copies"] = k5.accumulator_copies(1024, 4)[0]
    k5_wide["bytes"] = N_AGG * (8 + 4 * 8) + 8 * (1024 + 2 + 1026 * (1 + 4 * 4))
    k5_wide["bound_ms"] = k5_wide["bytes"] / bw * 1e3
    del wide_keys, wide_cols
    log(f"1024 groups x 4 columns: {k5_wide['ms']:.4f} ms "
        f"({k5_wide['copies']} accumulator copy a CTA), bound "
        f"{k5_wide['bound_ms']:.4f} ms -> "
        f"{k5_wide['bound_ms'] / k5_wide['ms']:.1%} of the bound")
    k5_sass = sass_atomics(build.library_path("aggregate"))

    # -- 9. main path: the configs[1] aggregate --------------------------
    phase("main path: hash_aggregate (configs[1])")
    aggs = [("v", "sum"), ("v", "count"), ("v", "min"), ("v", "max")]

    def agg_path():
        return gt.ops.hash_aggregate(agg_keys, aggs, {"v": (agg_f64, None)},
                                     max_groups=AGG_GROUPS)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    reset_launches()
    res = agg_path()                                      # warm-up
    torch.cuda.synchronize()
    agg_walls = []
    for _ in range(runs):
        t = time.perf_counter()
        res = agg_path()
        torch.cuda.synchronize()
        agg_walls.append(time.perf_counter() - t)
    agg_launches = LAUNCHES["aggregate"]
    agg_peak = torch.cuda.max_memory_allocated()
    agg_rows_s = N_AGG / min(agg_walls)
    log(f"n={N_AGG}: walls_s={[round(w, 6) for w in agg_walls]} "
        f"rows/s={agg_rows_s:.6g} K5 launches {agg_launches} (expected "
        f"{1 + runs}) max_memory_allocated={agg_peak} (resident before "
        f"the first call {resident}: the path's own {agg_peak - resident})")
    if agg_launches != 1 + runs:
        raise AssertionError("hash_aggregate did not launch K5 once a call")
    agg_busy, _ = profile_call(agg_path)
    # where one call's wall goes on the host: before K5's wrapper, inside it
    # (the ctypes call and its three launches), the decode after it, and
    # the wait for the device (median of 7 calls)
    # (hash_aggregate calls K5's wrapper through the module k5 names)
    marks = {}
    real_aggregate = k5.aggregate

    def timed_aggregate(*a, **k):
        marks["in"] = time.perf_counter()
        out = real_aggregate(*a, **k)
        marks["out"] = time.perf_counter()
        return out

    parts = {"before_k5_ms": [], "k5_wrapper_ms": [], "decode_ms": [],
             "device_wait_ms": [], "wall_ms": []}
    k5.aggregate = timed_aggregate
    try:
        for _ in range(7):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            agg_path()
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            for key, ms in (("before_k5_ms", marks["in"] - t0),
                            ("k5_wrapper_ms", marks["out"] - marks["in"]),
                            ("decode_ms", t1 - marks["out"]),
                            ("device_wait_ms", t2 - t1),
                            ("wall_ms", t2 - t0)):
                parts[key].append(ms * 1e3)
    finally:
        k5.aggregate = real_aggregate
    agg_host = {k: sorted(v)[len(v) // 2] for k, v in parts.items()}
    log("configs[1] call, host clock (median of 7): " + ", ".join(
        f"{k} {v:.4f}" for k, v in agg_host.items()))

    # its groups against K5's plain version on the same columns
    cnt = int(res["group_count"])
    if cnt != AGG_GROUPS or bool(res["overflow"]) or \
            bool(res["key_is_null"].any()):
        raise AssertionError(f"configs[1]: {cnt} groups, overflow "
                             f"{bool(res['overflow'])}")
    want = k5.aggregate_plain(agg_keys, None, agg_cols, AGG_GROUPS)
    acc = want.acc[0, :, :cnt]
    plain = {"keys": want.keys[:cnt], "agg:v:count": acc[k5.ROW_COUNT_VALID],
             "agg:v:min": k5.float_from_key(acc[k5.ROW_MIN], False),
             "agg:v:max": k5.float_from_key(acc[k5.ROW_MAX], True)}
    for k, w in plain.items():
        if not torch.equal(bits(res[k][:cnt]), bits(w)):
            raise AssertionError(f"configs[1] path: {k} differs from plain")
    torch.testing.assert_close(res["agg:v:sum"][:cnt],
                               acc[k5.ROW_SUM].view(torch.float64),
                               rtol=AGG_RTOL, atol=0)
    # and against pyarrow's group_by on the same columns, copied once
    host = pa.table({"k": agg_keys.cpu().numpy(), "v": agg_f64.cpu().numpy()})
    oracle = host.group_by("k").aggregate(
        [("v", "sum"), ("v", "count"), ("v", "min"), ("v", "max")]
    ).sort_by("k")
    got_np = {k: v[:cnt].cpu().numpy() for k, v in res.items()
              if k != "overflow" and k != "group_count"}
    for col, key in (("k", "keys"), ("v_count", "agg:v:count"),
                     ("v_min", "agg:v:min"), ("v_max", "agg:v:max")):
        if not np.array_equal(oracle.column(col).to_numpy(), got_np[key]):
            raise AssertionError(f"configs[1] path: {key} != pyarrow {col}")
    np.testing.assert_allclose(got_np["agg:v:sum"],
                               oracle.column("v_sum").to_numpy(),
                               rtol=AGG_RTOL)
    log(f"{cnt} groups equal to K5's plain version and to pyarrow "
        f"group_by (sums within rtol {AGG_RTOL})")
    del host, oracle, res, want, agg_keys, agg_f64, agg_i64

    # -- 9b. the generic group-by (past 1024 groups: no K5) --------------
    phase("hash_aggregate, generic path (10M rows, 3000 keys, max_groups "
          "4096)")
    gen_rows_s, gen_walls, cnt = drive_generic_groupby(gt, dev, g, aggs,
                                                       runs)
    log(json.dumps({"agg_path": {
        "rows_per_s": agg_rows_s, "walls_s": agg_walls, "rows": N_AGG,
        "groups": AGG_GROUPS, "max_memory_allocated": agg_peak,
        "resident_before": resident,
        "device_busy_share": agg_busy, "k5_launches": agg_launches,
        "host_clock_ms": agg_host, "k5_ms_int64_values": k5_i64_ms,
        "k5_ms_parts": k5_parts, "k5_wide": k5_wide,
        "k5_variants": k5_variants, "k5_sass": k5_sass,
        "generic_rows_per_s": gen_rows_s, "generic_walls_s": gen_walls,
        "generic_rows": N_GENERIC, "generic_groups": cnt}}))

    # -- 10. K4 and K3 against plain -------------------------------------
    phase("K4 and K3 against their plain versions")
    from gandiva_tpu_torch.ops import SortKey
    from gandiva_tpu_torch.ops.kernels import merge_path as k3
    from gandiva_tpu_torch.ops.kernels import sort_bitonic as k4
    from gandiva_tpu_torch.ops.sort import _build_operands, normalize_key

    g.manual_seed(13)
    # bench.py:116-118: int64 keys uniform in [-2^62, 2^62), one payload
    sort_keys = torch.randint(-2**62, 2**62, (N_SORT,), generator=g,
                              device=dev)
    sort_pay = torch.randint(0, 10**9, (N_SORT,), generator=g, device=dev)
    words = normalize_key(sort_keys).unsqueeze(0)   # configs[2]'s one word
    sort_err = sort_rounds_against_plain(words, f"configs[2] n={N_SORT}",
                                         every_round=False)
    n = N_RAGGED

    def two_nullable_keys():
        a = torch.randint(-5, 5, (n,), generator=g, device=dev)
        b = torch.randint(-2**62, 2**62, (n,), generator=g, device=dev)
        va = torch.rand(n, generator=g, device=dev) >= 0.1
        vb = torch.rand(n, generator=g, device=dev) >= 0.1
        return torch.stack(_build_operands(
            [SortKey(a, va), SortKey(b, vb, False, False)], None)[0])

    ragged_words = [
        ("ties", torch.randint(0, 3, (1, n), generator=g, device=dev)),
        ("sorted", torch.arange(n, device=dev).unsqueeze(0)),
        ("reversed", torch.arange(n, 0, -1, device=dev).unsqueeze(0)),
        ("two nullable keys", two_nullable_keys()),
        ("14 words", torch.randint(0, 2, (14, n), generator=g, device=dev)),
        ("all equal", torch.full((1, n), 7, dtype=torch.int64, device=dev)),
        ("n = 4W + 1", torch.randint(-2**62, 2**62, (
            1, 4 * (1 << k4.DEFAULT_W_LOG2) + 1), generator=g, device=dev)),
        ("n < W", torch.randint(-2**62, 2**62, (1, 1000), generator=g,
                                device=dev)),
        ("n = 0", torch.empty((1, 0), dtype=torch.int64, device=dev))]
    for label, w in ragged_words:
        sort_err = max(sort_err, sort_rounds_against_plain(
            w, f"ragged {label}"))
    if k4.tile_log2(14) >= k4.DEFAULT_W_LOG2:
        raise AssertionError("14 words did not halve the tile")
    del ragged_words

    # -- 11. sort times --------------------------------------------------
    phase("sort times")
    for name in ("sort_bitonic", "merge_path"):
        log(f"-Xptxas -v, csrc/{name}.cu:")
        for line in ptxas_lines(build_logs[name]):
            log("   " + line)
    # the tile sweep, one word: K4 and the whole merge_sort at each W
    w_sweep = {}
    for wl in range(11, k4.MAX_W_LOG2 + 1):
        w_sweep[wl] = {
            "k4_ms": time_ms(lambda: k4.block_sort_cuda(words, wl), iters=10),
            "merge_sort_ms": time_ms(lambda: k3.merge_sort(list(words), wl),
                                     iters=3, warmup=1),
            "rounds": k3.num_rounds(N_SORT, wl)}
        log(f"W=2^{wl}: K4 {w_sweep[wl]['k4_ms']:.4f} ms, merge_sort "
            f"{w_sweep[wl]['merge_sort_ms']:.4f} ms with "
            f"{w_sweep[wl]['rounds']} K3 rounds")
    w_log2 = k4.tile_log2(1)
    W = 1 << w_log2
    rounds = k3.num_rounds(N_SORT, w_log2)
    tiles = -(-N_SORT // W)
    padded = torch.cat([words[0], words.new_full((tiles * W - N_SORT,), -1)])
    k4_ms = time_ms(lambda: k4.block_sort_cuda(words, w_log2), iters=10)
    k4_plain_ms = time_ms(lambda: k4.block_sort_plain(words, w_log2),
                          iters=2, warmup=1)
    # one PyTorch call of the same function: a stable sort of every tile
    k4_library_ms = time_ms(lambda: torch.sort(
        (padded ^ I64_MIN).view(tiles, W), dim=1, stable=True), iters=3,
        warmup=1)
    k4_ms2 = time_ms(lambda: k4.block_sort_cuda(words, w_log2), iters=10)
    del padded
    sorted_tiles = k4.block_sort_cuda(words, w_log2)

    def k3_rounds(time_parts: bool):
        """Each round's time (and, if asked, its partition pass's, its
        plain version's and its library call's) from K4's output."""
        idx, cur = sorted_tiles
        spare = (torch.empty_like(cur), torch.empty_like(idx))
        times = {"round": [], "partition": [], "plain": [], "library": []}
        for r in range(rounds):
            run = W << r
            times["round"].append(time_ms(lambda: k3.merge_round_cuda(
                cur, idx, run, out=spare), iters=5))
            if time_parts:
                times["partition"].append(time_ms(
                    lambda: k3.merge_splits_cuda(cur, run), iters=5))
                times["plain"].append(time_ms(lambda: k3.merge_round_plain(
                    cur, idx, run), iters=1, warmup=1))
                pairs = -(-N_SORT // (2 * run))
                padded = torch.cat([cur[0], cur.new_full(
                    (pairs * 2 * run - N_SORT,), -1)]) ^ I64_MIN
                # one PyTorch call of the same function: a stable sort of
                # each pair
                times["library"].append(time_ms(lambda: torch.sort(
                    padded.view(pairs, 2 * run), dim=1, stable=True),
                    iters=2, warmup=1))
                del padded
            merged = k3.merge_round_cuda(cur, idx, run, out=spare)
            spare = (cur, idx)
            cur, idx = merged
        return times

    k3_times = k3_rounds(True)
    round_ms = k3_times["round"]
    k3_ms = sum(round_ms) / rounds
    k3_partition_ms = sum(k3_times["partition"]) / rounds
    k3_plain_ms = sum(k3_times["plain"]) / rounds
    k3_library_ms = sum(k3_times["library"]) / rounds
    # K3's tile: the mean round at T = 2^11 .. 2^13 outputs a CTA
    t_sweep = {}
    default_t = k3.MERGE_T_LOG2
    try:
        for t in (11, 12, 13):
            k3.MERGE_T_LOG2 = t
            t_sweep[t] = sum(k3_rounds(False)["round"]) / rounds
    finally:
        k3.MERGE_T_LOG2 = default_t
    log("K3 mean round by T: " + ", ".join(
        f"T=2^{t} {ms:.4f} ms" for t, ms in t_sweep.items()))
    del sorted_tiles
    merge_sort_ms = time_ms(lambda: k3.merge_sort(list(words)), iters=5)
    merge_sort_plain_ms = time_ms(lambda: plain_merge_sort(words, w_log2),
                                  iters=1, warmup=1)

    def sort_op():
        return gt.ops.sort_columns([SortKey(sort_keys)], [sort_pay])

    def sort_library():
        values, order = torch.sort(sort_keys, stable=True)
        return order, values, sort_pay.index_select(0, order)

    op_ms = time_ms(sort_op, iters=5)
    op_library_ms = time_ms(sort_library, iters=5)
    op_ms2 = time_ms(sort_op, iters=5)
    # least bytes, each input read once and each output written once:
    # K4 reads the word and writes word + index; a K3 round reads and
    # writes word + index; the operator reads key + payload and writes the
    # sorted key, sorted payload and perm
    k4_bound_ms = N_SORT * (8 + 8 + 4) / bw * 1e3
    k3_bound_ms = N_SORT * 2 * (8 + 4) / bw * 1e3
    merge_sort_bound_ms = N_SORT * (20 + rounds * 24) / bw * 1e3
    op_bound_ms = N_SORT * (16 + 8 + 8 + 4) / bw * 1e3
    log(f"n={N_SORT} W={W} rounds={rounds} K3 T=2^{default_t}")
    log(f"K4 k4_ms={k4_ms:.4f} (again {k4_ms2:.4f}) "
        f"plain_ms={k4_plain_ms:.4f} library_ms={k4_library_ms:.4f} "
        f"bound_ms={k4_bound_ms:.4f} -> {k4_bound_ms / k4_ms:.1%} of the "
        "bound")
    log(f"K3 mean round k3_ms={k3_ms:.4f} (first {round_ms[0]:.4f}, last "
        f"{round_ms[-1]:.4f}) plain_ms={k3_plain_ms:.4f} "
        f"library_ms={k3_library_ms:.4f} bound_ms={k3_bound_ms:.4f} -> "
        f"{k3_bound_ms / k3_ms:.1%} of the bound")
    log("K3 by round (ms): " + ", ".join(f"{x:.4f}" for x in round_ms))
    log("K3 partition pass by round (ms, inside the round's time): "
        + ", ".join(f"{x:.4f}" for x in k3_times["partition"])
        + f"; mean {k3_partition_ms:.4f}")
    log(f"merge_sort {merge_sort_ms:.4f} ms (plain {merge_sort_plain_ms:.4f}"
        f"; bound {merge_sort_bound_ms:.4f} ms, rows x (20 + {rounds} x 24) "
        f"B -> {merge_sort_bound_ms / merge_sort_ms:.1%})")
    log(f"sort_columns {op_ms:.4f} ms (again {op_ms2:.4f}); torch.sort + "
        f"index_select {op_library_ms:.4f} ms ({op_ms / op_library_ms:.3f}x)"
        f"; operator bound {op_bound_ms:.4f} ms -> "
        f"{op_bound_ms / op_ms:.1%}")

    # -- 12. main path: the configs[2] sort ------------------------------
    phase("main path: sort_columns (configs[2])")
    valid = torch.rand(N_SORT, generator=g, device=dev) >= 0.1
    sort_runs = {"no nulls": [SortKey(sort_keys)],
                 "10% null keys, nulls first": [SortKey(sort_keys, valid,
                                                        True, True)]}
    sort_launches = {"sort_block": 0, "merge_path": 0}
    sort_report = {}
    for label, keys in sort_runs.items():
        def sort_path(keys=keys):
            return gt.ops.sort_columns(keys, [sort_pay])

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        reset_launches()
        res = sort_path()                                 # warm-up
        torch.cuda.synchronize()
        walls = []
        for _ in range(runs):
            t = time.perf_counter()
            res = sort_path()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
        peak = torch.cuda.max_memory_allocated()
        busy, _ = profile_call(sort_path)
        launched = {k: LAUNCHES[k] for k in sort_launches}
        calls = 2 + runs
        words_ = torch.stack(_build_operands(keys, None)[0])
        tile = k4.tile_log2(words_.shape[0])
        call_rounds = k3.num_rounds(N_SORT, tile)
        if launched != {"sort_block": calls,
                        "merge_path": calls * call_rounds}:
            raise AssertionError(f"{label}: {launched} in {calls} calls, "
                                 f"expected K4 once and K3 {call_rounds} "
                                 "rounds a call")
        for k in sort_launches:
            sort_launches[k] += launched[k]
        rows_s = N_SORT / min(walls)
        perm, (sk,), (sp,) = res
        want = plain_merge_sort(words_, tile)[0]
        if not torch.equal(perm, want):
            raise AssertionError(f"{label}: perm differs from the plain "
                                 "merge sort")
        if not (torch.equal(sk, sort_keys.index_select(0, perm))
                and torch.equal(sp, sort_pay.index_select(0, perm))):
            raise AssertionError(f"{label}: sorted columns != columns[perm]")
        nwords = words_.shape[0]
        del words_, want, res, perm, sk, sp
        log(f"{label}: n={N_SORT} walls_s={[round(w, 6) for w in walls]} "
            f"rows/s={rows_s:.6g} launches {launched} in {calls} calls "
            f"(W=2^{tile}, {call_rounds} rounds a call) "
            f"max_memory_allocated={peak} (resident before the first call "
            f"{resident}: the path's own {peak - resident}); perm equal to "
            "the plain merge sort's, sorted key and payload equal to "
            "columns[perm]")
        sort_report[label] = {"rows_per_s": rows_s, "walls_s": walls,
                              "max_memory_allocated": peak,
                              "resident_before": resident,
                              "device_busy_share": busy,
                              "words": nwords, "tile_log2": tile,
                              "rounds_per_call": call_rounds}
    del sort_keys, sort_pay, valid, words

    # the ragged multi-key sort against pyarrow, copied to the host once
    n = N_RAGGED
    a = torch.randint(-50, 50, (n,), generator=g, device=dev)
    va = torch.rand(n, generator=g, device=dev) >= 0.1
    f = torch.randint(-8, 8, (n,), generator=g, device=dev).double() / 2
    u = torch.rand(n, generator=g, device=dev)
    f = torch.where(u < 0.05, float("nan"), f)
    f = torch.where((u >= 0.05) & (u < 0.1), -0.0, f)
    f = torch.where((u >= 0.1) & (u < 0.12), float("inf"), f)
    f = torch.where((u >= 0.12) & (u < 0.14), float("-inf"), f)
    p1 = torch.randint(-2**62, 2**62, (n,), generator=g, device=dev)
    p2 = torch.rand(n, generator=g, device=dev)
    perm, (sa, sf), (sp1, sp2) = gt.ops.sort_columns(
        [SortKey(a, va, True, True), SortKey(f, None, False, True)],
        [p1, p2])
    host = {k: v.cpu().numpy() for k, v in dict(
        a=a, va=va, f=f, p1=p1, p2=p2, perm=perm, sa=sa, sf=sf, sp1=sp1,
        sp2=sp2).items()}
    table = pa.table({"a": pa.array(host["a"], mask=~host["va"]),
                      "f": host["f"], "p1": host["p1"], "p2": host["p2"]})
    order = pc.sort_indices(table, sort_keys=[("a", "ascending"),
                                              ("f", "descending")],
                            null_placement="at_start")
    taken = table.take(order)
    got = pa.table({"a": pa.array(host["sa"], mask=~host["va"][host["perm"]]),
                    "p1": host["sp1"], "p2": host["sp2"]})
    if not np.array_equal(host["perm"], np.asarray(order)):
        raise AssertionError("ragged sort: perm != pyarrow sort_indices")
    # f by its bits: Arrow's equality holds NaN unequal and -0.0 == 0.0
    if not got.equals(taken.select(["a", "p1", "p2"])) or not np.array_equal(
            host["sf"].view(np.int64),
            taken.column("f").to_numpy().view(np.int64)):
        raise AssertionError("ragged sort: columns != pyarrow take")
    log(f"ragged n={n}: nullable int64 key (nulls first) + descending f64 "
        "key with -0.0, NaN, ±inf, two payloads: equal to pyarrow "
        "sort_indices and take, row for row")
    del host, table, taken, got
    log(json.dumps({"sort_path": {
        "rows": N_SORT, "runs": sort_report, "rounds_per_call": rounds,
        "tile_rows": W, "k3_tile_rows": 1 << default_t,
        "launches": sort_launches, "k4_ms": k4_ms, "k3_round_ms": round_ms,
        "k3_partition_ms": k3_times["partition"],
        "w_sweep": w_sweep, "k3_t_sweep_mean_round_ms": t_sweep,
        "merge_sort_ms": merge_sort_ms,
        "merge_sort_plain_ms": merge_sort_plain_ms,
        "merge_sort_bound_ms": merge_sort_bound_ms,
        "sort_columns_ms": op_ms, "library_ms": op_library_ms,
        "sort_columns_over_library": op_ms / op_library_ms,
        "operator_bound_ms": op_bound_ms}}))

    # -- 13. K2 against plain --------------------------------------------
    phase("K2 against its plain version and K1")
    from gandiva_tpu_torch.ops import hash_join as hj
    from gandiva_tpu_torch.ops.compaction import compact_fragnet
    from gandiva_tpu_torch.ops.kernels import compaction_fragnet as k2

    def hold_k2(mask, cols, what):
        """K2 against its plain version and against K1, bit for bit on
        [:count]; returns the largest absolute payload difference."""
        got = k2.compact_fragnet_cuda(mask, cols)
        torch.cuda.synchronize()
        err = hold(got, k2.compact_fragnet_plain(mask, cols), what)
        hold(got, compact_columns_cuda(mask, cols), f"{what} (K1)")
        torch.cuda.synchronize()
        return err, int(got[2])

    g.manual_seed(17)
    u = torch.rand(N_BIG, generator=g, device=dev)
    f64 = torch.rand(N_BIG, generator=g, dtype=torch.float64, device=dev)
    vb = torch.rand(N_BIG, generator=g, device=dev) < 0.5
    k2_err = 0.0
    for d in DENSITIES:
        err, c = hold_k2(u < d, [f64, vb], f"K2 n={N_BIG} density={d}")
        k2_err = max(k2_err, err)
        log(f"n={N_BIG} density={d}: count={c} matches plain and K1")
    mask_r = torch.rand(N_RAGGED, generator=g, device=dev) < 0.43
    ragged = [torch.randint(-10**12, 10**12, (N_RAGGED,), generator=g,
                            dtype=torch.int64, device=dev),
              torch.rand(N_RAGGED, generator=g, device=dev),
              torch.randint(-2**31, 2**31 - 1, (N_RAGGED,), generator=g,
                            dtype=torch.int32, device=dev),
              torch.rand(N_RAGGED, generator=g, device=dev) < 0.5]
    many = ragged + [c.flip(0) for c in ragged] + ragged[:2]
    for label, cols in (("4 payloads", ragged), ("10 payloads", many)):
        before = LAUNCHES["compact_fragnet"]
        err, c = hold_k2(mask_r, cols, f"K2 ragged {label}")
        k2_err = max(k2_err, err)
        launched = LAUNCHES["compact_fragnet"] - before
        if launched != -(-len(cols) // MAX_PAYLOADS):
            raise AssertionError(f"K2 {label}: {launched} launches")
        log(f"ragged n={N_RAGGED} {label}: count={c} matches plain and K1 "
            f"({launched} launches)")
    for n in (0, 1, 1000, 4096 * 5 - 1):
        hold_k2(mask_r[:n], [c[:n] for c in ragged], f"K2 n={n}")
        log(f"n={n}: matches plain and K1")
    # views at an offset: the mask and the 1- and 4-byte payloads are not
    # 16-B aligned (byte loads and survivor-by-survivor staging), and the
    # 8-byte payload is only 8-B aligned
    for off in (1, 3):
        err, c = hold_k2(mask_r[off:], [col[off:] for col in ragged],
                         f"K2 views at offset {off}")
        k2_err = max(k2_err, err)
        log(f"views at offset {off} (mask and payloads not 16-B aligned): "
            f"count={c} matches plain and K1")
    del u, f64, vb
    huge = torch.rand(N_HUGE, generator=g, device=dev) < 0.5
    hold_k2(huge, [], f"K2 n={N_HUGE}")
    log(f"n={N_HUGE} (65,536 tiles) density 0.5: matches plain and K1")
    del huge
    # back to back, nothing checked until all have run: the status words
    # of one call must not leak into the next
    masks = [torch.rand(N_RAGGED, generator=g, device=dev) < (k + 1) / 21
             for k in range(BACK_TO_BACK)]
    runs = [k2.compact_fragnet_cuda(m, ragged[:2]) for m in masks]
    torch.cuda.synchronize()
    for k, (m, got) in enumerate(zip(masks, runs)):
        k2_err = max(k2_err, hold(got, k2.compact_fragnet_plain(
            m, ragged[:2]), f"K2 back-to-back call {k}"))
    log(f"{BACK_TO_BACK} back-to-back calls at n={N_RAGGED}: each matches "
        "plain")
    del masks, runs, ragged, many, mask_r

    # -- 14. K2 times ----------------------------------------------------
    phase("K2 times")

    def compaction_times(mask, pay, iters):
        """K2, K1, K2's plain version and nonzero + index_select on the
        same inputs (CUDA events), and the byte bound of
        ``compaction_bytes``."""
        def library():
            sel = torch.nonzero(mask).flatten()
            return [p.index_select(0, sel) for p in pay]

        t = {"k2_ms": time_ms(lambda: k2.compact_fragnet_cuda(mask, pay),
                              iters=iters),
             "k1_ms": time_ms(lambda: compact_columns_cuda(mask, pay),
                              iters=iters),
             "plain_ms": time_ms(lambda: k2.compact_fragnet_plain(mask, pay),
                                 iters=max(iters // 5, 2)),
             "library_ms": time_ms(library, iters=max(iters // 5, 2)),
             "k2_ms_again": time_ms(lambda: k2.compact_fragnet_cuda(
                 mask, pay), iters=iters)}
        survivors = int(mask.sum())
        width = sum(p.element_size() for p in pay)
        t["rows"], t["survivors"] = mask.shape[0], survivors
        t["bytes"] = compaction_bytes(mask.shape[0], survivors, width)
        t["bound_ms"] = t["bytes"] / bw * 1e3
        log(json.dumps(t))
        return t

    g.manual_seed(7)
    u = torch.rand(N_BIG, generator=g, device=dev)
    f64 = torch.rand(N_BIG, generator=g, dtype=torch.float64, device=dev)
    vb = torch.rand(N_BIG, generator=g, device=dev) < 0.5
    k2_flagship = compaction_times(u < FLAGSHIP_DENSITY, [f64, vb], 50)
    log(f"flagship shape: K2 {k2_flagship['k2_ms']:.4f} ms, K1 "
        f"{k2_flagship['k1_ms']:.4f} ms, bound "
        f"{k2_flagship['bound_ms']:.4f} ms")
    del u, f64, vb

    # the two residue compactions of one configs[3] probe chunk's hot-key
    # probe, on the inputs the probe gives them: the cold rows with their
    # int64 key, then the rows round 1 leaves unresolved with their next
    # slot and key
    n_chunk = N_JOIN_FULL // JOIN_CHUNKS
    full_build = torch.arange(JOIN_FULL_BUILD, device=dev)
    jt_full = hj.build_join_table(full_build, how="inner")

    def chunk_fn(i):
        gi = torch.Generator(device=dev)
        gi.manual_seed(1000 + i)
        return zipf_keys(n_chunk, JOIN_FULL_BUILD, gi)

    keys0 = chunk_fn(0)
    kv = torch.ones(n_chunk, dtype=torch.bool, device=dev)
    residues = []

    def recording(mask, payload=()):
        residues.append((mask, list(payload)))
        return compact_fragnet(mask, payload)

    hj.compact_fragnet = recording
    try:
        hj._probe_ranges_hot(jt_full.table, JOIN_FULL_BUILD,
                             hj.normalize_key(keys0), kv, 128)
    finally:
        hj.compact_fragnet = compact_fragnet
    if [len(cols) for _, cols in residues] != [1, 2]:
        raise AssertionError("the hot-key probe did not compact its two "
                             "residues")
    for (mask, cols), what in zip(residues, ("cold residue", "tier 2")):
        k2_err = max(k2_err, hold(k2.compact_fragnet_cuda(mask, cols),
                                  k2.compact_fragnet_plain(mask, cols),
                                  f"K2 configs[3] chunk 0 {what}"))
        log(f"configs[3] chunk 0 {what} ({mask.shape[0]} rows, "
            f"{[c.dtype for c in cols]}): K2 matches plain")
    cold, (pk64,) = residues[0]
    del residues
    k2_cold = compaction_times(cold, [pk64], 20)
    log(f"configs[3] chunk 0 cold residue: {k2_cold['survivors']} of "
        f"{n_chunk} rows; K2 {k2_cold['k2_ms']:.4f} ms, K1 "
        f"{k2_cold['k1_ms']:.4f} ms, plain {k2_cold['plain_ms']:.4f} ms, "
        f"nonzero + index_select {k2_cold['library_ms']:.4f} ms, bound "
        f"{k2_cold['bound_ms']:.4f} ms -> "
        f"{k2_cold['bound_ms'] / k2_cold['k2_ms']:.1%} of the bound")
    del cold, pk64, kv

    # -- 15. the configs[3] join, resident -------------------------------
    phase("main path: join (configs[3], resident)")
    g.manual_seed(3)
    probe = zipf_keys(N_JOIN, JOIN_BUILD, g)
    build = torch.arange(JOIN_BUILD, device=dev)
    iota = torch.arange(N_JOIN, dtype=torch.int32, device=dev)
    join_launches = {"join_probe": 0, "sort_block": 0, "merge_path": 0,
                     "join_build": 0}
    join_report = {}
    for unique in (False, True):
        def join_path(unique=unique):
            return gt.ops.join(probe, build, N_JOIN, "inner",
                               build_unique=unique)

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        reset_launches()
        res = join_path()                                 # warm-up
        torch.cuda.synchronize()
        walls = []
        for _ in range(3):
            t = time.perf_counter()
            res = join_path()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
        launched = {k: LAUNCHES[k] for k in join_launches}
        peak = torch.cuda.max_memory_allocated()
        if min(launched.values()) == 0:
            raise AssertionError(f"join (build_unique={unique}): launches "
                                 f"{launched}")
        for k in join_launches:
            join_launches[k] += launched[k]
        if not (int(res.count) == N_JOIN and not bool(res.overflow)
                and torch.equal(res.probe_idx, iota)
                and torch.equal(res.build_idx.long(), probe)):
            raise AssertionError(f"join (build_unique={unique}): outputs "
                                 "differ from the identity")
        rows_s = N_JOIN / min(walls)
        log(f"build_unique={unique}: n={N_JOIN} walls_s="
            f"{[round(w, 6) for w in walls]} rows/s={rows_s:.6g} launches "
            f"{launched} in 4 calls; max_memory_allocated={peak} (the "
            f"path's own {peak - resident}); count == n, probe_idx == "
            "arange(n), build_idx == keys")
        join_report[f"build_unique={unique}"] = {
            "rows_per_s": rows_s, "walls_s": walls,
            "max_memory_allocated": peak, "resident_before": resident,
            "launches": launched}
    with keep_largest_inputs({}) as kept:
        join_path()
    hold_kept_kernels(kept, "configs[3] join", ("join_build", "join_probe"))
    del kept
    diag = hj.probe_diagnostics(hj.build_join_table(build), probe)
    log(f"probe_diagnostics: { {k: int(v) for k, v in diag.items()} }")
    del res, probe, build, iota

    # -- 16. the full configs[3], streaming ------------------------------
    phase("main path: join_stream (configs[3] full, 1,024,000,000 rows)")

    def consume(res):
        return (res.count.to(torch.int64)
                + res.probe_idx.to(torch.int64).sum()
                + res.build_idx.to(torch.int64).sum())

    stream = gt.ops.join_stream(full_build, JOIN_CHUNKS, chunk_fn=chunk_fn,
                                capacity=n_chunk, how="inner",
                                consume=consume)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    reset_launches()
    outs, ovf = stream()                                  # warm-up
    torch.cuda.synchronize()
    walls = []
    for _ in range(2):
        t = time.perf_counter()
        outs, ovf = stream()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
    join_stream_launches = {k: LAUNCHES[k] for k in join_launches}
    peak = torch.cuda.max_memory_allocated()
    if min(join_stream_launches.values()) == 0:
        raise AssertionError(f"join_stream: launches {join_stream_launches}")
    full_rows_s = JOIN_CHUNKS * n_chunk / min(walls)
    if bool(ovf):
        raise AssertionError("join_stream overflowed")
    for i in range(JOIN_CHUNKS):
        want = n_chunk + n_chunk * (n_chunk - 1) // 2 + int(chunk_fn(i).sum())
        if int(outs[i]) != want:
            raise AssertionError(f"chunk {i}: checksum {int(outs[i])} != "
                                 f"{want}")
    log(f"{JOIN_CHUNKS} chunks × {n_chunk} rows against "
        f"{JOIN_FULL_BUILD} build rows: walls_s="
        f"{[round(w, 6) for w in walls]} rows/s={full_rows_s:.6g} launches "
        f"{join_stream_launches} in 3 calls; max_memory_allocated={peak} (the "
        f"path's own {peak - resident}); every chunk's checksum equals "
        "n + Σ iota + Σ keys")
    # host syncs of one probe_chunk (on the card: the identity expansion's
    # one decision; the probe kernel reads nothing back)
    syncs = count_syncs(lambda: hj.probe_chunk(jt_full, keys0, n_chunk,
                                               "inner"))
    diag = {k: int(v) for k, v in hj.probe_diagnostics(jt_full,
                                                       keys0).items()}
    log(f"one probe_chunk of {n_chunk} rows: {syncs} host syncs; "
        f"probe_diagnostics {diag}")
    stream_busy, _ = profile_call(stream)
    with keep_largest_inputs({}) as kept:
        stream()
    hold_kept_kernels(kept, "configs[3] join_stream",
                      ("join_build", "join_probe"))
    del jt_full, keys0, outs, kept
    log(json.dumps({"join_path": {
        "resident": join_report, "rows": N_JOIN, "build_rows": JOIN_BUILD,
        "stream_rows_per_s": full_rows_s, "stream_walls_s": walls,
        "stream_rows": JOIN_CHUNKS * n_chunk,
        "stream_build_rows": JOIN_FULL_BUILD,
        "stream_max_memory_allocated": peak,
        "stream_resident_before": resident,
        "stream_device_busy_share": stream_busy,
        "stream_launches": join_stream_launches,
        "syncs_per_probe_chunk": syncs, "chunk_diagnostics": diag,
        "resident_launches": join_launches, "k2_flagship": k2_flagship,
        "k2_cold_residue": k2_cold}}))

    # -- 17. the join against Arrow --------------------------------------
    phase("join against pyarrow.acero")
    g.manual_seed(19)
    n, nb = N_ARROW_PROBE, N_ARROW_BUILD
    probe = zipf_keys(n, ARROW_KEYS, g)
    build = torch.randint(0, ARROW_KEYS, (nb,), generator=g, device=dev)
    pv = torch.rand(n, generator=g, device=dev) >= 0.1
    bv = torch.rand(nb, generator=g, device=dev) >= 0.1
    p2 = torch.randint(0, 4, (n,), generator=g, device=dev)
    b2 = torch.randint(0, 4, (nb,), generator=g, device=dev)
    host = {k: v.cpu().numpy() for k, v in dict(
        probe=probe, build=build, pv=pv, bv=bv, p2=p2, b2=b2).items()}
    pc_ = np.bincount(host["probe"][host["pv"]], minlength=ARROW_KEYS)
    bc_ = np.bincount(host["build"][host["bv"]], minlength=ARROW_KEYS)
    cap = int((pc_ * bc_).sum()) + n + nb
    pt = pa.table({"k": pa.array(host["probe"], mask=~host["pv"]),
                   "k2": host["p2"], "pv": np.arange(n)})
    bt = pa.table({"k": pa.array(host["build"], mask=~host["bv"]),
                   "k2": host["b2"], "bv": np.arange(nb)})
    acero_launches = {k: 0 for k in join_launches}
    for how in JOIN_HOWS:
        reset_launches()
        res = gt.ops.join(probe, build, cap, how, probe_valid=pv,
                          build_valid=bv)
        c = int(res.count)
        for k in acero_launches:
            acero_launches[k] += LAUNCHES[k]
        if bool(res.overflow):
            raise AssertionError(f"{how}: overflow at capacity {cap}")
        got = pair_codes(res.probe_idx[:c].cpu().numpy(),
                         res.build_idx[:c].cpu().numpy(), nb)
        if not np.array_equal(got, acero_pairs(pt, bt, "k", how, nb)):
            raise AssertionError(f"{how}: pairs differ from acero")
        log(f"{how}: {c} rows equal to pyarrow.acero's hashjoin")
    for how in ("inner", "full"):
        res = gt.ops.join_multi([probe, p2], [build, b2], cap, how,
                                probe_valids=[pv, None],
                                build_valids=[bv, None])
        c = int(res.count)
        got = pair_codes(res.probe_idx[:c].cpu().numpy(),
                         res.build_idx[:c].cpu().numpy(), nb)
        if bool(res.overflow) or not np.array_equal(
                got, acero_pairs(pt, bt, ["k", "k2"], how, nb)):
            raise AssertionError(f"join_multi {how}: differs from acero")
        log(f"join_multi {how} on two keys: {c} rows equal to acero")
    jt = hj.build_join_table(build, build_valid=bv)
    pk = hj.normalize_key(probe)
    dense = hj._probe_ranges_dense(jt.table, nb, pk, pv)
    hot = hj._probe_ranges_hot(jt.table, nb, pk, pv, 128)
    if not (torch.equal(dense[0][pv], hot[0][pv])
            and torch.equal(dense[1][pv], hot[1][pv])):
        raise AssertionError("hot path (start, len) != dense path")
    log(f"hot path (start, len) equal to the dense path's on the valid "
        f"rows; hot {int(hot[2]['hot_rows'])} rows, dense residue "
        f"{int(dense[2]['residue_rows'])}")
    if min(acero_launches.values()) == 0:
        raise AssertionError(f"join vs Arrow: launches {acero_launches}")
    del probe, build, pv, bv, p2, b2, host, pt, bt, jt, dense, hot, res

    # -- 18. the decimal, date/time, interval and hash registry ----------
    phase("the decimal, date/time, interval and hash registry, card "
          "against CPU")
    hold_registry(gt, dev)
    time_pow10_division(dev)

    # -- 19. TPC-H Q1, Q6 and Q7 lineitem scans at SF10 ------------------
    phase("main path: TPC-H Q1, Q6 and Q7 lineitem scans (SF10, resident)")
    k1_by_path.update(drive_tpch(gt, dev, smi))

    # -- 20. the string and binary registry ------------------------------
    phase("the string and binary registry, card against CPU")
    hold_string_registry(gt, dev)
    string_route_syncs(gt, dev)

    # -- 21. TPC-H string scans at SF10 ----------------------------------
    phase("main path: TPC-H string scans compiled (Q1, Q12, Q19 over "
          "LINEITEM; Q9, Q16 over PART; Q22 over CUSTOMER; SF10)")
    scan_k1, scan_plan_launches = drive_string_scans(gt, dev, smi)
    k1_by_path.update(scan_k1)

    # -- 22. configs[4]: SF10 ORDERS ⋈ CUSTOMER over 4 partitions ---------
    phase("main path: configs[4] filter→join→agg→sort, TPC-H SF10 ORDERS ⋈ "
          "CUSTOMER as 4 partitions of one card")
    pipe_launches, pipe_errs = drive_configs4(gt, dev, smi)
    sort_err = max(sort_err, pipe_errs["sort"])
    k5_err = max(k5_err, pipe_errs["aggregate"])

    # -- 23. distributed_step ---------------------------------------------
    phase("main path: distributed_step over one configs[0] batch as 4 "
          "partitions")
    step_launches, step_errs = drive_distributed_step(gt, dev, smi)
    max_err = max(max_err, step_errs["compact"])
    k5_err = max(k5_err, step_errs["aggregate"])
    k1_by_path["distributed_step"] = step_launches["compact"]

    # -- 24. profile in a fresh process -----------------------------------
    phase("profile and cost_analysis of the flagship plan, fresh process")
    profile_fresh_process(smi)

    # -- 25. the scaling harnesses ----------------------------------------
    phase("the scaling harnesses over 1, 2 and 4 partitions of one card")
    drive_scaling(dev, smi)

    # -- 26. the plan compiler --------------------------------------------
    phase("the plan compiler: every emitter, and the entry points' plans "
          "compiled against eager")
    plan_report, plan_by_path = drive_plan_compiler(gt, dev, smi)
    flagship_region = plan_report["configs[0] flagship_stream"]

    # -- 27. the join build's kernels -------------------------------------
    phase("the join build's kernels against the plain chain, and their "
          "times")
    join_build = drive_join_build(dev, bw, smi)["orders_customer_pipeline"]

    # -- 28. the join probe's kernel ---------------------------------------
    phase("the join probe's kernel against the reference's chains, and its "
          "times")
    join_probe = drive_join_probe(dev, bw, smi)["orders_customer_pipeline"]

    # -- 29. hot-key membership -------------------------------------------
    phase("hot-key membership's kernel against the plain route, and its "
          "times")
    key_table = drive_key_table(dev, bw, smi)[
        "orders_customer_pipeline probe, all invalid"]

    # -- the kernels line, then the last line ----------------------------
    # each path's own count, read just after it ran; ``launches`` is the
    # count of the path that brought the kernel in
    def by_path(name):
        return {"configs[2] sort_columns": sort_launches[name],
                "configs[3] join": join_launches[name],
                "configs[3] join_stream": join_stream_launches[name],
                "configs[4] pipeline": pipe_launches[name]}

    log(json.dumps({"kernels": [{
        "name": "compact",
        "route": "cuda",
        "source": "gandiva_tpu_torch/csrc/compaction.cu",
        "replaces": "gandiva_tpu/ops/kernels/compaction_pallas.py:45",
        "launches": main_launches,
        "launches_by_path": k1_by_path,
        "matches_plain": True,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes",
        "library_ms": library_ms,
    }, {
        # no main path compacts with K2 since the join probe's kernel; the
        # reference's probe chains on the card (probe_diagnostics, phase
        # 14's hot-key probe) still do
        "name": "compact_fragnet",
        "route": "cuda",
        "source": "gandiva_tpu_torch/csrc/compaction_fragnet.cu",
        "replaces": "gandiva_tpu/ops/kernels/compaction_pallas.py:190",
        "launches": pipe_launches["compact_fragnet"],
        "launches_by_path": {
            "configs[4] pipeline": pipe_launches["compact_fragnet"]},
        "matches_plain": True,
        "max_abs_err": k2_err,
        "ms": k2_cold["k2_ms"],
        "plain_ms": k2_cold["plain_ms"],
        "bound_ms": k2_cold["bound_ms"],
        "bound_by": "bytes",
        "library_ms": k2_cold["library_ms"],
    }, {
        "name": "aggregate",
        "route": "cuda",
        "source": "gandiva_tpu_torch/csrc/aggregate.cu",
        "replaces": "gandiva_tpu/ops/kernels/agg_pallas.py:147",
        "launches": agg_launches,
        "launches_by_path": {"configs[1] hash_aggregate": agg_launches,
                             "configs[4] pipeline": pipe_launches["aggregate"],
                             "distributed_step": step_launches["aggregate"]},
        "matches_plain": True,
        "max_abs_err": k5_err,
        "ms": k5_ms,
        "plain_ms": k5_plain_ms,
        "bound_ms": k5_bound_ms,
        "bound_by": "bytes",
        "library_ms": k5_library_ms,
    }, {
        "name": "sort_block",
        "route": "cuda",
        "source": "gandiva_tpu_torch/csrc/sort_bitonic.cu",
        "replaces": "gandiva_tpu/ops/kernels/sort_bitonic.py:69",
        "launches": sort_launches["sort_block"],
        "launches_by_path": by_path("sort_block"),
        "matches_plain": True,
        "max_abs_err": sort_err,
        "ms": k4_ms,
        "plain_ms": k4_plain_ms,
        "bound_ms": k4_bound_ms,
        "bound_by": "bytes",
        "library_ms": k4_library_ms,
    }, {
        "name": "merge_path",
        "route": "cuda",
        "source": "gandiva_tpu_torch/csrc/merge_path.cu",
        "replaces": "gandiva_tpu/ops/kernels/merge_path.py:153",
        # a round is two launches, its partition pass and its merge
        "launches_count": "rounds",
        "launches": sort_launches["merge_path"],
        "launches_by_path": by_path("merge_path"),
        "matches_plain": True,
        "max_abs_err": sort_err,
        "ms": k3_ms,
        "plain_ms": k3_plain_ms,
        "bound_ms": k3_bound_ms,
        "bound_by": "bytes",
        "library_ms": k3_library_ms,
    }, {
        # the plan compiler's kernel, generated per plan; it replaces XLA's
        # fusion of the plan, not a Pallas kernel. plain_ms is the eager
        # route over the same nodes; no one PyTorch call computes a plan
        "name": "plan",
        "route": "cuda (generated)",
        "source": "gandiva_tpu_torch/compiler/codegen.py",
        "replaces": "gandiva_tpu/compiler/projector.py:70",
        "launches": arrow_plan_launches + stream_plan_launches,
        "launches_by_path": {
            "configs[0] Arrow entry point": arrow_plan_launches,
            "configs[0] flagship_stream": stream_plan_launches,
            **scan_plan_launches, **plan_by_path},
        "matches_plain": True,
        "max_abs_err": 0.0,
        "ms": flagship_region["kernel_ms"],
        "plain_ms": flagship_region["eager_region_ms"],
        "bound_ms": flagship_region["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
    }, {
        # replaces no Pallas kernel: the reference builds the table with
        # array operations (lax.cummin, lax.cummax) that XLA fuses. ms is
        # the two kernels' time on orders_customer_pipeline's build
        "name": "join_build",
        "route": "cuda",
        "source": "gandiva_tpu_torch/csrc/join_build.cu",
        "replaces": "gandiva_tpu/ops/hash_join.py:554",
        "launches": join_stream_launches["join_build"],
        "launches_by_path": {
            "configs[3] join": join_launches["join_build"],
            "configs[3] join_stream": join_stream_launches["join_build"],
            "configs[4] pipeline": pipe_launches["join_build"]},
        "matches_plain": True,
        "max_abs_err": 0.0,
        "ms": join_build["ms"],
        "route_ms": join_build["route_ms"],
        "plain_ms": join_build["plain_ms"],
        "bound_ms": join_build["bound_ms"],
        "bound_by": "bytes",
        "library_ms": join_build["library_ms"],
    }, {
        # replaces no Pallas kernel: the reference probes with array
        # operations (gathers, compactions, walks) that XLA fuses. ms is the
        # kernel's time on orders_customer_pipeline's probe; plain_ms the
        # dense chain's there; no one PyTorch call computes the probe
        "name": "join_probe",
        "route": "cuda",
        "source": "gandiva_tpu_torch/csrc/join_probe.cu",
        "replaces": "gandiva_tpu/ops/hash_join.py:695",
        "launches": join_stream_launches["join_probe"],
        "launches_by_path": {
            "configs[3] join": join_launches["join_probe"],
            "configs[3] join_stream": join_stream_launches["join_probe"],
            "configs[4] pipeline": pipe_launches["join_probe"]},
        "matches_plain": True,
        "max_abs_err": 0.0,
        "ms": join_probe["ms"],
        "plain_ms": join_probe["dense_ms"],
        "hot_ms": join_probe["hot_ms"],
        "bound_ms": join_probe["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
    }, {
        # replaces no Pallas kernel: the reference compares every key with
        # every entry, which XLA fuses. ms is the kernel's time on
        # orders_customer_pipeline's probe keys; plain_ms the plain route's
        # there; library_ms torch.isin's on the masked table
        "name": "key_table",
        "route": "cuda",
        "source": "gandiva_tpu_torch/csrc/key_table.cu",
        "replaces": "gandiva_tpu/parallel/ops.py:242",
        "launches": pipe_launches["key_table"],
        "launches_by_path": {
            "configs[4] pipeline": pipe_launches["key_table"]},
        "matches_plain": True,
        "max_abs_err": 0.0,
        "ms": key_table["ms"],
        "plain_ms": key_table["plain_ms"],
        "bound_ms": key_table["bound_ms"],
        "bound_by": "bytes",
        "library_ms": key_table["isin_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}), flush=True)
    return 0


T0 = time.perf_counter()

if __name__ == "__main__":
    sys.exit(main())
