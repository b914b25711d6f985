"""One run of one cell: set-up, the window (or the traced slice), the
check of the answers, and the result line.

Everything a cell needs is found by name: its configuration file (the
``file`` that ``BENCHMARK.json`` gives it), the configuration's driver
(``drivers/<driver>.py``), the traffic mix (``traffic/<traffic>.json``),
and each metric's reader (``metrics/<name>.py``).
"""
from __future__ import annotations

import bisect
import gc
import importlib
import json
import subprocess
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

from benchmark.harness import guard
from benchmark.harness.loop import Window, closed_loop
from benchmark.harness.peaks import hbm_bytes_per_s

HERE = Path(__file__).resolve().parents[1]          # benchmark/
ROOT = HERE.parent


@dataclass
class Run:
    """What the metric readers read."""
    setup_s: float
    window: Window
    trace: Optional[object]
    peak_bytes_per_s: float


def load_manifest(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def resolve(manifest: dict, workload: str) -> dict:
    """The cell's entry, configuration, traffic and metrics, by name."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    entry = {c["name"]: c for c in manifest["configs"]}[cell["config"]]
    config = json.loads((ROOT / entry["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{cell['traffic']}.json")
                         .read_text())

    def applies(m):
        return workload in m.get("workloads", [workload])

    end_to_end = [m for m in manifest["end_to_end"] if applies(m)]
    reported = {m["name"] for m in end_to_end}
    per_layer = [m for m in manifest["per_layer"]
                 if (workload in m["workloads"] if "workloads" in m
                     else m["moves"] in reported)]
    return {"cell": cell, "config": config, "traffic": traffic,
            "end_to_end": end_to_end, "per_layer": per_layer}


def card(device) -> dict:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    import torch

    info = {"name": torch.cuda.get_device_name(device)}
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        info["nvidia_smi"] = smi.stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError) as e:
        info["nvidia_smi"] = f"not read: {e}"
    return info


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             t0: float, device="cuda", rows: Optional[int] = None,
             manifest: Optional[dict] = None):
    """Run ``workload`` once. ``device`` and ``rows`` (a smaller table)
    are for the tests on the CPU. Returns (result, checks, info)."""
    import gandiva_tpu_torch as gt
    import torch

    spec = resolve(manifest or load_manifest(), workload)
    cell, config, traffic = spec["cell"], spec["config"], spec["traffic"]
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    driver = importlib.import_module(
        f"benchmark.drivers.{config['driver']}").Driver(
            gt, config, traffic, seed, dev, rows)
    driver.warm_shapes()
    # the closed loop itself for a while, keeping answers as the window
    # does, so that the card's clocks and the allocator's pool have
    # settled before the window
    closed_loop(driver.next_request, driver.record, traffic["warm_seconds"],
                on_card=on_card)
    driver.forget()
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t0
    tslice = None
    if trace:
        from benchmark.harness.trace import traced_loop
        win, tslice = traced_loop(driver.next_request, driver.record,
                                  min(seconds, traffic["trace_seconds"]),
                                  on_card)
    else:
        win = closed_loop(driver.next_request, driver.record, seconds,
                          on_card=on_card)
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    failed = sum(r.failed for r in win.requests)
    driver.release()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    found = driver.check()
    limits = config["limits"]
    checks = {"failed_requests": {"value": failed, "limit": 0}}
    checks.update({k: {"value": found[k], "limit": limits[k]}
                   for k in limits})
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    name = card(dev) if on_card else {"name": str(dev)}
    run = Run(setup_s, win, tslice,
              hbm_bytes_per_s(name["name"]) if on_card else 0.0)
    metrics = {}
    for m in (spec["per_layer"] if trace else spec["end_to_end"]):
        value = importlib.import_module(
            f"benchmark.metrics.{m['name']}").read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": correct, "attempted": len(win.requests),
              "failed": failed, "metrics": metrics,
              "device": {"platform": "gpu" if on_card else dev.type,
                         "kind": name["name"],
                         "count": cell["chips"],
                         "memory_peak_bytes": peak}}
    if tslice is not None:
        result["device"].update(busy_s=tslice.busy_s,
                                window_s=tslice.window_s)
        result["breakdown"] = tslice.breakdown()
    result["checks"] = checks
    info = {"workload": workload, "seed": seed, "card": name,
            "window_s": win.seconds, "setup_s": setup_s,
            "compared_answers": found.get("compared_answers"),
            "by_label": _by_label(win)}
    if tslice is not None:
        info["trace_events"] = tslice.kinds
        info["syncs_by_call"] = _syncs_by_name(tslice)
    if hasattr(driver, "counts"):
        info["pipeline_counts"] = driver.counts
    return result, checks, info


def _syncs_by_name(tslice) -> dict:
    """Copies and synchronizations the host called inside the traced
    calls, by name: what ``host_syncs_per_request`` counts, and beside it
    what it leaves out."""
    out = {}
    starts = [r.call.start for r in tslice.requests]
    for o in tslice.host:
        if "ynchron" in o.name or "emcpy" in o.name:
            i = bisect.bisect_right(starts, o.start) - 1
            if i >= 0 and o.start <= tslice.requests[i].call.end:
                out[o.name] = out.get(o.name, 0) + 1
    return out


def _by_label(win: Window) -> dict:
    """Requests, rows, survivors and median latency by label."""
    out = {}
    for r in win.requests:
        d = out.setdefault(r.label, {"requests": 0, "rows": 0,
                                     "survivors": 0, "ms": []})
        d["requests"] += 1
        d["rows"] += r.rows
        d["survivors"] += r.survivors or 0
        d["ms"].append(r.latency_ms)
    for d in out.values():
        ms = sorted(d.pop("ms"))
        d["median_ms"] = ms[len(ms) // 2]
    return out


def emit(result: dict, checks: dict, info: dict) -> int:
    """Print the run's lines: the information line, then each number
    compared beside its limit on standard error, and the result as the
    last line of standard output. Refuses (exit 4, no result) if a module
    of JAX or of the JAX package is loaded."""
    found = guard.forbidden_modules()
    if found:
        print(f"loaded modules that this benchmark may not load: {found}",
              file=sys.stderr)
        return 4
    print(json.dumps({"info": info}), flush=True)
    for k, c in checks.items():
        print(f"check {k}: {c['value']} (limit {c['limit']})",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0
