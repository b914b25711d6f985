"""The exchange sized by the rows that move (``parallel.exchange_sized``),
the join's output sized by the pairs it emits, and the pipeline's
own-partition entry point, on the CPU.

- The sized exchange gives every partition the rows the capacity-sized
  exchange (the reference's ``[P, cap]`` layout, held to ``gandiva_tpu``
  in ``test_torch_parallel.py``) gives it where valid, in the same order,
  on meshes of 1, 2 and 4 partitions in one process.
- Its receive buffers hold the rows that move and not one slot more (the
  slack is 0), and its ``gt.exchange`` span counts them.
- A join with no capacity emits the pairs of one with room to spare.
- The own-partition entry point over two gloo processes of two partitions
  each equals the same query in one process and the plain reference; a
  rank that raises ends every rank non-zero within the test's limit.
Each test that starts processes bounds them with its own time limit.
"""
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gandiva_tpu_torch import parallel, tracing
from gandiva_tpu_torch.ops import hash_join
from gandiva_tpu_torch.parallel import mesh as t_mesh
from gandiva_tpu_torch.parallel import ops as t_ops
from gandiva_tpu_torch.parallel import shuffle as t_shuffle

WORKER = os.path.join(os.path.dirname(__file__),
                      "torch_mp_own_partitions_worker.py")
ORDERS = 4000


def _exchange_inputs(P, n=600, seed=0):
    rng = np.random.default_rng(seed + P)
    total = n * P
    keys = rng.integers(0, 500, total).astype(np.int64)
    valid = rng.random(total) < 0.85
    payload = {"k": keys, "i": np.arange(total, dtype=np.int64),
               "f": rng.random(total).astype(np.float32),
               "b": rng.random(total) < 0.5,
               "u": rng.integers(0, 255, total).astype(np.uint8)}
    return keys, valid, payload


@pytest.mark.parametrize("P", [1, 2, 4])
def test_sized_exchange_gives_the_capacity_layouts_rows(P):
    keys, valid, payload = _exchange_inputs(P)
    mesh = parallel.make_mesh(P, device="cpu")
    sh = {k: t_mesh.shard(mesh, v) for k, v in payload.items()}
    ok = t_mesh.shard(mesh, valid)
    cap = keys.shape[0]                          # room for every row
    full, fvalid, overflow = t_shuffle.shuffle_by_key(sh["k"], ok, sh, mesh,
                                                      cap)
    sized, svalid, sov = t_shuffle.shuffle_by_key(sh["k"], ok, sh, mesh,
                                                  None)
    assert not bool(overflow) and not bool(sov)
    for p in range(P):
        assert bool(svalid[p].all())
        for name in payload:
            assert sized[name][p].dtype == full[name][p].dtype
            assert torch.equal(sized[name][p], full[name][p][fvalid[p]]), \
                (p, name)
    got = sorted(int(i) for p in range(P) for i in sized["i"][p])
    assert got == np.nonzero(valid)[0].tolist()


@pytest.mark.parametrize("P", [1, 2, 4])
def test_sized_exchange_holds_the_rows_that_move(P):
    """Slack 0: each receive buffer holds exactly the valid rows hashed to
    its partition, and the span's ``slots`` equal its ``rows``."""
    keys, valid, payload = _exchange_inputs(P, seed=7)
    mesh = parallel.make_mesh(P, device="cpu")
    sh = [t_mesh.shard(mesh, x) for x in (keys, valid)]
    part = [parallel.shuffle.partition_of(k, P, 0) for k in sh[0]]
    tracing.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("gt.exchange"):
            flat, fvalid, _ = t_shuffle.exchange_flat(
                part, sh[1], {"k": sh[0]}, mesh, None)
    spans = tracing.spans()
    tracing.clear()
    dest = np.concatenate([p.numpy() for p in part])
    want = [int(((dest == p) & valid).sum()) for p in range(P)]
    assert [x.shape[0] for x in flat["k"]] == want
    assert [x.shape[0] for x in fvalid] == want
    ex = spans[0]
    assert ex.name == "gt.exchange"
    assert ex.counters["slots"] == ex.counters["rows"] == sum(want)
    assert [s.name for s in spans].count("gt.sync.exchange_counts") == 1


@pytest.mark.parametrize("how", ["inner", "left", "right", "full", "semi",
                                 "anti"])
@pytest.mark.parametrize("unique", [False, True])
def test_join_with_no_capacity_emits_the_pairs_it_has(how, unique):
    rng = np.random.default_rng(3)
    build = (rng.permutation(3000)[:700] if unique
             else rng.integers(0, 400, 700)).astype(np.int64)
    probe = rng.integers(0, 500, 2000).astype(np.int64)
    pv = rng.random(2000) < 0.9
    bv = rng.random(700) < 0.95
    args = dict(probe_valid=torch.from_numpy(pv),
                build_valid=torch.from_numpy(bv))
    pk, bk = torch.from_numpy(probe), torch.from_numpy(build)
    roomy = hash_join.join(pk, bk, 20000, how, **args)
    sized = hash_join.join(pk, bk, None, how, **args)
    assert not bool(roomy.overflow) and not bool(sized.overflow)
    c = int(roomy.count)
    # the pairs emitted, or the probe's rows on the identity expansion
    assert int(sized.count) == c
    assert c <= sized.probe_idx.shape[0] <= max(c, probe.shape[0])
    assert torch.equal(sized.probe_idx[:c], roomy.probe_idx[:c])
    assert torch.equal(sized.build_idx[:c], roomy.build_idx[:c])


@pytest.mark.parametrize("how", ["inner", "semi", "right", "full"])
def test_sized_skewed_join_emits_the_capacity_joins_rows(how):
    """``dist_join_skewed`` with every capacity None against the same join
    with room to spare: each partition emits the same rows."""
    P, nper, build_per = 4, 512, 32
    rng = np.random.default_rng(11)
    probe = (rng.zipf(1.3, P * nper) % 200).astype(np.int64)
    pv = rng.integers(0, 1000, P * nper).astype(np.int64)
    build = rng.permutation(400)[:P * build_per].astype(np.int64)
    bv = rng.integers(0, 1000, P * build_per).astype(np.int64)
    bvalid = rng.random(P * build_per) >= 0.1
    mesh = parallel.make_mesh(P, device="cpu")
    sh = [t_mesh.shard(mesh, x) for x in (probe, pv, build, bv, bvalid)]
    ones = [torch.ones_like(x, dtype=torch.bool) for x in sh[0]]
    rows = []
    for caps in ((P * nper, P * build_per, 8 * nper), (None, None, None)):
        _, cols, row_ok, overflow = t_ops.dist_join_skewed(
            sh[0], ones, {"pv": (sh[1], None)}, sh[2], sh[4],
            {"bv": (sh[3], None)}, mesh, probe_capacity=caps[0],
            build_capacity=caps[1], out_capacity=caps[2], how=how,
            num_hot=16, hot_replicate_capacity=64)
        assert not any(bool(o) for o in overflow)
        names = ["pv"] + ([] if how == "semi" else ["bv"])
        rows.append([sorted((tuple(int(cols[n][0][p][i]) if cols[n][1][p][i]
                                   else None for n in names)
                             for i in np.nonzero(row_ok[p].numpy())[0]),
                            key=str) for p in range(P)])
    assert rows[0] == rows[1] and sum(map(len, rows[1])) > 0


def test_own_partitions_in_one_process_equal_global_columns():
    from benchmark.data.orders_customer_chunks import orders_customer_chunk

    chunks = [orders_customer_chunk(1, ORDERS, 4 * ORDERS, ORDERS // 10, 4,
                                    k, 5, "cpu") for k in range(4)]
    names = ("o_custkey", "o_totalprice", "c_custkey", "c_mktsegment")
    mesh = parallel.make_mesh(4, device="cpu")
    own = parallel.run_pipeline_with_retry(
        mesh, *[[c[n] for c in chunks] for n in names], num_groups=8,
        filter_threshold=14_000_000)
    glob = parallel.run_pipeline_with_retry(
        mesh, *[torch.cat([c[n] for c in chunks]) for n in names],
        num_groups=8, filter_threshold=14_000_000)
    for a, b in zip(own[:3], glob[:3]):
        np.testing.assert_array_equal(a, b)
    assert own[3]["join_out"] == glob[3]["join_out"] > 0
    with pytest.raises(ValueError, match="holds 4"):
        parallel.run_pipeline_with_retry(
            mesh, *[[c[n] for c in chunks[:2]] for n in names])


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_workers(tmp_path, world: int, kind: str, timeout: int,
                mode: str = "run", orders: int = ORDERS):
    """``world`` worker processes; returns (return codes, outputs, rank
    0's JSON or None)."""
    out = str(tmp_path / "own.json")
    port = str(_free_port())
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(r), str(world), port, out, kind,
         str(orders), mode], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(world)]
    try:
        outs = [p.communicate(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            p.kill()
    doc = None
    if os.path.exists(out):
        with open(out) as f:
            doc = json.load(f)
    return [p.returncode for p in procs], outs, doc


def test_own_partitions_over_two_processes_match_one_and_the_reference(
        tmp_path):
    """Two gloo processes of two partitions each: the answers equal the
    plain reference's over the whole tables and one process's over the
    same four partitions. Limit: 60 s."""
    rcs, outs, doc = run_workers(tmp_path, 2, "cpu", timeout=60)
    assert rcs == [0, 0], [err[-3000:] for _, err in outs]
    assert doc["answers"] == doc["reference"]
    import torch_mp_own_partitions_worker as w

    mesh = parallel.make_mesh(w.PARTITIONS, device="cpu")
    t = w.chunks(mesh, ORDERS, "cpu")
    for x in w.XS:
        one = w.answer(parallel.run_pipeline_with_retry(
            mesh, t["o_custkey"], t["o_totalprice"], t["c_custkey"],
            t["c_mktsegment"], num_groups=8, filter_threshold=x))
        assert one == doc["answers"][str(x)]
        assert one[3] > 0


def test_a_rank_that_raises_ends_every_rank_non_zero(tmp_path):
    """Rank 1 raises once the group is formed; rank 0, waiting in the
    pipeline's first collective, raises at the group's timeout (40 s) or
    sooner, so both end non-zero well inside the test's limit of 60 s."""
    rcs, outs, doc = run_workers(tmp_path, 2, "cpu", timeout=60,
                                 mode="raise")
    assert rcs[0] not in (0, None) and rcs[1] not in (0, None), rcs
    assert "fails on purpose" in outs[1][1]
    assert doc is None


def test_collectives_record_their_spans_and_bytes():
    """Under a process group (one gloo process here), each collective of
    the mesh is a ``gt.collective.*`` span whose counters add up to the
    bytes it carries; the sized exchange's data moves in one all-to-all a
    column and its counts in one all-gather."""
    parallel.join_group("gloo", _free_port(), 1, 0, 20)
    try:
        mesh = parallel.make_mesh(2, device="cpu")
        keys = [torch.arange(0, 100), torch.arange(100, 300)]
        valid = [torch.ones(100, dtype=torch.bool),
                 torch.ones(200, dtype=torch.bool)]
        part = [k % 2 for k in keys]
        tracing.clear()
        with profile(activities=[ProfilerActivity.CPU]):
            with tracing.span("gt.exchange"):
                flat, _, _ = t_shuffle.exchange_flat(part, valid,
                                                     {"k": keys}, mesh, None)
            mesh.psum([torch.ones(4, dtype=torch.int64)] * 2)
        spans = tracing.spans()
        tracing.clear()
    finally:
        parallel.leave_group()
    by = {}
    for s in spans:
        by.setdefault(s.name, []).append(s.counters)
    assert by["gt.collective.all_gather"] == [
        {"bytes_off_card": 0, "bytes_on_card": 4 * 8}]      # 2 × 2 counts
    assert by["gt.collective.all_to_all"] == [
        {"bytes_off_card": 0, "bytes_on_card": 300 * 8}]
    assert by["gt.collective.all_reduce"] == [
        {"bytes_off_card": 0, "bytes_on_card": 4 * 8}]
    assert sorted(torch.cat(flat["k"]).tolist()) == list(range(300))
