"""The control of a cell's correctness check: the plain reference put in
the program's place, computed with float32 money (the precision below the
exact decimals the configurations state), judged by the same comparison
and limits as a run. It must come out not correct.

    python3 benchmark/control.py --workload <name> --seeds <n> [<n> ...]

runs it at the cell's own size on the card, one JSON line a seed. The
benchmark's runs never run it.
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def run_control(workload: str, seed: int, device="cuda", rows=None,
                manifest=None) -> dict:
    """The control's checks for ``workload`` on ``seed``: each number
    against its limit, and whether all hold (they must not)."""
    import importlib

    import gandiva_tpu_torch as gt
    import torch

    from benchmark.harness import main as harness

    spec = harness.resolve(manifest or harness.load_manifest(), workload)
    config = spec["config"]
    driver = importlib.import_module(
        f"benchmark.drivers.{config['driver']}").Driver(
            gt, config, spec["traffic"], seed, torch.device(device), rows)
    driver.release()
    found = driver.check(driver.control_answers())
    checks = {k: {"value": found[k], "limit": v}
              for k, v in config["limits"].items()}
    return {"workload": workload, "seed": seed, "checks": checks,
            "compared_answers": found["compared_answers"],
            "correct": all(c["value"] <= c["limit"]
                           for c in checks.values())}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args()
    for seed in args.seeds:
        print(json.dumps(run_control(args.workload, seed)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
