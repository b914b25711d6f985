"""The correctness check shown to fail: the control (the reference in
float32 in the program's place) and a run with the program broken
underneath come out not correct, on each cell, while a sound run of the
same cell comes out correct. On the CPU at a small size; the ``gpu``
case runs the control on the card."""
import time

import pytest
import torch

import gandiva_tpu_torch as gt
from benchmark.control import run_control
from benchmark.harness import main as harness

MANIFEST = harness.load_manifest()
CELLS = [w["name"] for w in MANIFEST["workloads"]]
ROWS = 20_000
SEEDS = [2**31 + 3, 3_000_000_017, 12]


def run(cell, seed=2**31 + 1):
    result, checks, _ = harness.run_cell(cell, seed, 0.3, False,
                                         time.perf_counter(), device="cpu",
                                         rows=ROWS, manifest=MANIFEST)
    return result


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    r = run(cell)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell, seed):
    c = run_control(cell, seed, device="cpu", rows=ROWS, manifest=MANIFEST)
    assert c["compared_answers"] > 0 and not c["correct"], c


def _alter_scan(monkeypatch):
    """An answer altered where it is produced: the first projected value
    of every scan off by one."""
    real = gt.FilterProject.evaluate_device

    def altered(self, batch):
        sel, out = real(self, batch)
        if out.length:
            col = out.column(self.exprs[0].result_field.name)
            col.data[0] += 1
        return sel, out

    monkeypatch.setattr(gt.FilterProject, "evaluate_device", altered)


def _half_scan(monkeypatch):
    """Half of the batch left out: each scan over its first half."""
    real = gt.FilterProject.evaluate_device
    monkeypatch.setattr(gt.FilterProject, "evaluate_device",
                        lambda self, b: real(self, b.slice(0, b.length // 2)))


def _alter_groups(monkeypatch):
    """An answer altered where it is produced: the first group's sum off
    by one cent."""
    real = gt.parallel.run_pipeline_with_retry

    def altered(*a, **k):
        keys, sums, counts, metrics = real(*a, **k)
        sums = sums.copy()
        sums[0] += 1
        return keys, sums, counts, metrics

    monkeypatch.setattr(gt.parallel, "run_pipeline_with_retry", altered)


def _half_groups(monkeypatch):
    """Half of the batch left out: the query over the first half of the
    orders."""
    real = gt.parallel.run_pipeline_with_retry

    def half(mesh, ok, oa, ck, cs, **k):
        n = ok.shape[0] // 2
        return real(mesh, ok[:n], oa[:n], ck, cs, **k)

    monkeypatch.setattr(gt.parallel, "run_pipeline_with_retry", half)


FAULTS = {"lineitem": [_alter_scan, _half_scan],
          "orders": [_alter_groups, _half_groups]}


@pytest.mark.parametrize("fault", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_broken_program_is_not_correct(cell, fault, monkeypatch):
    FAULTS[cell.split("_")[0]][fault](monkeypatch)
    r = run(cell)
    assert not r["correct"], r["checks"]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_control_on_the_card_is_not_correct(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    c = run_control(cell, SEEDS[0], device="cuda", rows=ROWS * 10,
                    manifest=MANIFEST)
    assert c["compared_answers"] > 0 and not c["correct"], c
