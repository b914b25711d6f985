"""The check that nothing the run loads is JAX or the JAX package."""
import json
import os
import subprocess
import sys

from benchmark.harness import guard
from benchmark.harness.main import ROOT


def test_top_level_names_compared_whole():
    assert guard.forbidden_modules({"jax": 1, "jax.numpy": 1}) == [
        "jax", "jax.numpy"]
    assert guard.forbidden_modules({"gandiva_tpu.ops": 1}) == [
        "gandiva_tpu.ops"]
    assert guard.forbidden_modules({"jaxlib": 1, "flax.linen": 1}) == [
        "flax.linen", "jaxlib"]
    assert guard.forbidden_modules({"gandiva_tpu_torch": 1,
                                    "gandiva_tpu_torch.ops": 1,
                                    "jaxtyping": 1, "jax_utils": 1}) == []


def test_harness_program_and_reference_load_no_jax():
    code = ("import sys, json; sys.path.insert(0, sys.argv[1]);"
            "import gandiva_tpu_torch, benchmark.harness.main,"
            " benchmark.harness.trace, benchmark.drivers.lineitem_scans,"
            " benchmark.drivers.orders_customer;"
            "from benchmark.harness import guard;"
            "print(json.dumps(guard.forbidden_modules()))")
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)],
                         capture_output=True, text=True, check=True,
                         timeout=300)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_reference_imports_nothing_of_the_program():
    code = ("import sys, json; sys.path.insert(0, sys.argv[1]);"
            "import benchmark.reference.orders_customer;"
            "import benchmark.reference.tpch_q1, benchmark.reference.tpch_q6,"
            " benchmark.reference.tpch_q7, benchmark.reference.tpch_q12,"
            " benchmark.reference.tpch_q19, benchmark.data.lineitem,"
            " benchmark.data.orders_customer;"
            "print(json.dumps(sorted(m for m in sys.modules"
            " if m.split('.')[0] in ('gandiva_tpu_torch', 'gandiva_tpu',"
            " 'jax'))))")
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)],
                         capture_output=True, text=True, check=True,
                         timeout=300)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_run_refuses_without_a_card():
    import pytest
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is here: the refusal needs a machine without")
    env = dict(os.environ)
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "lineitem_scans_resident", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=300, env=env)
    assert out.returncode != 0 and out.stdout == ""
