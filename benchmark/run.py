"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The cells, their configurations, traffic
mixes and metrics are named in ``BENCHMARK.json`` and found by name under
``benchmark/``. With ``--trace 0`` the result carries the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics from a
profiled slice. Exits non-zero with no result when the cell's cards are
not there, or when a module of JAX or of the JAX package was loaded.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD = os.path.join(ROOT, "build")
# every build and kernel cache at a fixed place inside the checkout
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(BUILD, "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(BUILD, "triton")
os.environ["CUDA_CACHE_PATH"] = os.path.join(BUILD, "cuda_cache")
sys.path.insert(0, ROOT)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args()

    from benchmark.harness import main as harness

    manifest = harness.load_manifest()
    chips = harness.resolve(manifest, args.workload)["cell"]["chips"]
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    result, checks, info = harness.run_cell(
        args.workload, args.seed, args.seconds, bool(args.trace), T0,
        manifest=manifest)
    return harness.emit(result, checks, info)


if __name__ == "__main__":
    sys.exit(main())
