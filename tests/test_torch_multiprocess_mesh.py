"""The port's mesh across processes: two gloo processes holding two
partitions each form a 4-partition mesh and must give row-identical
results to one process holding all four (the counterpart of
test_multiprocess_mesh.py). The worker is tests/torch_mp_pipeline_worker.py;
the test's own time limit is 50 s."""
import json
import os
import socket
import subprocess
import sys

WORKER = os.path.join(os.path.dirname(__file__), "torch_mp_pipeline_worker.py")


def free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run_mesh_workers(tmp_path, world: int, kind: str, timeout: int) -> None:
    """One process holding all 4 partitions, then ``world`` processes
    dividing them; asserts every result is row-identical."""
    single_out = str(tmp_path / "single.json")
    dist_out = str(tmp_path / "dist.json")
    port = str(free_port())
    runs = [["single", "0", "1", "0", single_out, kind]] + [
        ["dist", str(r), str(world), port, dist_out, kind]
        for r in range(world)]
    procs = [subprocess.Popen([sys.executable, WORKER, *args],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True)
             for args in runs]
    try:
        outs = [p.communicate(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out}\n{err[-3000:]}"
    with open(single_out) as f:
        single = json.load(f)
    with open(dist_out) as f:
        dist = json.load(f)
    assert single["keys"] and not single["shuffle_overflow"]
    assert not single["sort_overflow"]
    for k in single:
        assert dist[k] == single[k], k


def test_two_process_mesh_matches_single_process(tmp_path):
    run_mesh_workers(tmp_path, 2, "cpu", timeout=50)
