"""The port's distribution layer (``gandiva_tpu_torch.parallel``) against
``gandiva_tpu.parallel`` on the CPU, on the same inputs made with numpy from
a seed.

The reference runs its per-shard bodies under ``jax.shard_map`` on the
8-device CPU mesh of ``tests/conftest.py``; the port runs them over
``make_mesh(8, device="cpu")``, one process holding all eight partitions.
Results are compared per partition, not only globally: integers, keys,
counts and flags bit for bit; float sums at rtol 1e-12; group tables after
sorting each partition's groups by key (the aggregate's group order is the
tier's own). The reference's own tests are the models:
``test_shuffle.py``, ``test_distributed_ops.py`` and ``test_pipeline.py``.
"""
import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from gandiva_tpu.parallel import mesh as j_mesh
from gandiva_tpu.parallel import ops as j_ops
from gandiva_tpu.parallel import pipeline as j_pipe
from gandiva_tpu.parallel import shuffle as j_shuffle
from gandiva_tpu.utils import hashing as j_hash
from gandiva_tpu_torch.parallel import mesh as t_mesh
from gandiva_tpu_torch.parallel import ops as t_ops
from gandiva_tpu_torch.parallel import pipeline as t_pipe
from gandiva_tpu_torch.parallel import shuffle as t_shuffle
from gandiva_tpu_torch.utils import hashing as t_hash

AXIS = j_mesh.PARTITION_AXIS
NDEV = 8


@pytest.fixture(scope="module")
def meshes():
    assert len(jax.devices()) == NDEV
    return j_mesh.make_mesh(), t_mesh.make_mesh(NDEV, device="cpu")


def _jshard(mesh, *arrays):
    sh = NamedSharding(mesh, P(AXIS))
    return tuple(jax.device_put(jnp.asarray(a), sh) for a in arrays)


def _per_part(ref) -> np.ndarray:
    """A reference output sharded over the axis, one row per partition."""
    return np.asarray(ref).reshape(NDEV, -1)


def _port(xs) -> np.ndarray:
    """A port output (one tensor per partition), one row per partition."""
    return torch.stack(list(xs)).numpy().reshape(NDEV, -1)


def _same(ref, port, what="", widths=True):
    """Per partition, bit for bit; ``widths=False`` compares the values of
    integer counts whose dtype the two packages choose apart."""
    r, p = _per_part(ref), _port(port)
    if not widths:
        r, p = r.astype(np.int64), p.astype(np.int64)
    assert r.dtype.itemsize == p.dtype.itemsize, what
    np.testing.assert_array_equal(p.view(r.dtype) if r.dtype != p.dtype
                                  else p, r, err_msg=what)


# ---------------------------------------------------------------------------
# partition_of
# ---------------------------------------------------------------------------

_KEY_DTYPES = [np.int8, np.int16, np.int32, np.int64, np.uint8, np.uint16,
               np.uint32, np.uint64, np.float32, np.float64]


def _keys(dtype, n=5000, seed=0):
    rng = np.random.default_rng(seed)
    if np.dtype(dtype).kind == "f":
        x = rng.standard_normal(n).astype(dtype) * 1e3
        x[:4] = [0.0, -0.0, np.inf, -np.inf]
        return x
    info = np.iinfo(dtype)
    x = rng.integers(info.min, info.max, n, dtype=dtype, endpoint=True)
    x[:2] = [info.min, info.max]
    return x


@pytest.mark.parametrize("dtype", _KEY_DTYPES)
@pytest.mark.parametrize("num_partitions", [1, 3, 8])
@pytest.mark.parametrize("seed", [0, 0x5EED])
def test_partition_of_matches_reference(dtype, num_partitions, seed):
    keys = _keys(dtype, seed=seed)
    want = np.asarray(j_hash.partition_of(jnp.asarray(keys), num_partitions,
                                          jnp.uint32(seed)))
    got = t_hash.partition_of(torch.from_numpy(keys), num_partitions, seed)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.min() >= 0 and got.max() < num_partitions


def test_hash_determinism_and_spread():
    """test_shuffle.py::test_hash_determinism_and_spread on the port."""
    keys = torch.arange(100000, dtype=torch.int64)
    h1 = t_hash.hash32(keys)
    assert torch.equal(h1, t_hash.hash32(keys))
    counts = np.bincount(t_hash.partition_of(keys, 8).numpy(), minlength=8)
    assert counts.min() > 0.95 * len(keys) / 8
    assert (h1 != t_hash.hash32(keys, 1)).double().mean() > 0.99
    assert ((t_hash.hash64(keys) >> 32) & 0xFFFF_FFFF).any()


@pytest.mark.parametrize("distinct,max_groups", [
    (5000, 256), (200, 64), (100000, 64), (50, 16), (3000, 1024),
    (1 << 40, 128), (10, 4), (70, 16)])
def test_group_ids_deterministic_matches_reference(distinct, max_groups):
    """``group_ids(deterministic=True)``, which the hot-key detection
    uses, numbers slots and groups as the reference does (the highest row
    index wins a contended slot), overflowing tables included."""
    from gandiva_tpu.ops.groupby import group_ids as j_group_ids
    from gandiva_tpu_torch.ops.groupby import group_ids as t_group_ids

    rng = np.random.default_rng(distinct)
    keys = rng.integers(0, distinct, 20000).astype(np.int64)
    valid = rng.random(20000) < 0.9
    want = j_group_ids(jnp.asarray(keys), jnp.asarray(valid),
                       max_groups=max_groups)
    got = t_group_ids(torch.from_numpy(keys), torch.from_numpy(valid),
                      max_groups=max_groups, deterministic=True)
    for w, g_ in zip(want, got):
        np.testing.assert_array_equal(g_.numpy(), np.asarray(w))


# ---------------------------------------------------------------------------
# the shuffle
# ---------------------------------------------------------------------------

def test_shuffle_by_key_matches_reference(meshes):
    jm, tm = meshes
    nper = 256
    total = nper * NDEV
    rng = np.random.default_rng(0)
    keys = rng.integers(0, 1000, size=total).astype(np.int64)
    vals = np.arange(total, dtype=np.int64)
    valid = rng.random(total) < 0.9
    cap = 2 * nper

    def step(k, v, ok):
        flat, fvalid, overflow = j_shuffle.shuffle_by_key(
            k, ok, {"key": k, "val": v}, AXIS, cap)
        return flat["key"], flat["val"], fvalid, overflow

    f = jax.jit(jax.shard_map(step, mesh=jm, in_specs=(P(AXIS),) * 3,
                              out_specs=(P(AXIS),) * 3 + (P(),)))
    rk, rv, rvalid, rov = f(*_jshard(jm, keys, vals, valid))
    sh = [t_mesh.shard(tm, x) for x in (keys, vals, valid)]
    flat, fvalid, overflow = t_shuffle.shuffle_by_key(
        sh[0], sh[2], {"key": sh[0], "val": sh[1]}, tm, cap)
    assert not bool(overflow) and not bool(rov)
    _same(rk, flat["key"], "keys")
    _same(rv, flat["val"], "payload")
    _same(rvalid, fvalid, "validity")
    # the round trip: every valid row arrives once, on its key's partition
    got_v, got_ok = _port(flat["val"]), _port(fvalid)
    assert sorted(got_v[got_ok].tolist()) == sorted(vals[valid].tolist())
    parts = t_hash.partition_of(torch.from_numpy(keys), NDEV).numpy()
    for p in range(NDEV):
        assert (parts[got_v[p][got_ok[p]]] == p).all()


def test_shuffle_overflow_detected(meshes):
    jm, tm = meshes
    nper = 128
    total = nper * NDEV
    keys = np.zeros(total, dtype=np.int64)      # one hot partition
    vals = np.arange(total, dtype=np.int64)
    valid = np.ones(total, dtype=bool)
    cap = nper // 2

    def step(k, v, ok):
        return j_shuffle.shuffle_by_key(k, ok, {"val": v}, AXIS, cap)[2]

    f = jax.jit(jax.shard_map(step, mesh=jm, in_specs=(P(AXIS),) * 3,
                              out_specs=P()))
    assert bool(f(*_jshard(jm, keys, vals, valid)))
    sh = [t_mesh.shard(tm, x) for x in (keys, vals, valid)]
    _, _, overflow = t_shuffle.shuffle_by_key(sh[0], sh[2], {"val": sh[1]},
                                              tm, cap)
    assert bool(overflow)
    # the same exchange with room for every row does not overflow
    _, _, overflow = t_shuffle.shuffle_by_key(sh[0], sh[2], {"val": sh[1]},
                                              tm, nper)
    assert not bool(overflow)


def test_bucket_by_partition_matches_reference():
    rng = np.random.default_rng(3)
    n, P_, cap = 1000, 5, 150
    part = rng.integers(0, P_, n).astype(np.int32)
    valid = rng.random(n) < 0.8
    cols = {"i": rng.integers(-99, 99, n).astype(np.int64),
            "f": rng.random(n).astype(np.float32),
            "b": rng.random(n) < 0.5,
            "u": rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(
                np.uint32)}
    rs, rc, ro = j_shuffle.bucket_by_partition(
        jnp.asarray(part), jnp.asarray(valid),
        {k: jnp.asarray(v) for k, v in cols.items()}, P_, cap)
    ts, tc, to = t_shuffle.bucket_by_partition(
        torch.from_numpy(part), torch.from_numpy(valid),
        {k: torch.from_numpy(v) for k, v in cols.items()}, P_, cap)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(rc))
    assert bool(to) == bool(ro)
    for k in cols:
        np.testing.assert_array_equal(ts[k].numpy(), np.asarray(rs[k]),
                                      err_msg=k)


# ---------------------------------------------------------------------------
# distributed operators
# ---------------------------------------------------------------------------

def _groups(keys, count, cols):
    """One partition's group rows, sorted by key: {key: (col values...)}."""
    c = int(count)
    return {int(k): tuple(col[i] for col in cols)
            for i, k in enumerate(np.asarray(keys)[:c])}


def test_dist_hash_aggregate_matches_reference(meshes):
    jm, tm = meshes
    nper = 512
    total = nper * NDEV
    rng = np.random.default_rng(0)
    keys = rng.integers(0, 50, total).astype(np.int64)
    vals = rng.integers(-100, 100, total).astype(np.int64)
    fvals = rng.standard_normal(total)
    valid = rng.random(total) < 0.9
    key_valid = rng.random(total) < 0.95
    aggs = [("v", "sum"), ("v", "count"), ("v", "min"), ("v", "max"),
            ("f", "sum")]

    def step(k, v, fv, ok, kv):
        res = j_ops.dist_hash_aggregate(
            k, ok, {"v": (v, None), "f": (fv, None)}, aggs, AXIS,
            capacity=4 * nper, key_valid=kv, max_groups=128)
        return {n: (x[None] if x.ndim == 0 else x) for n, x in res.items()}

    f = jax.jit(jax.shard_map(step, mesh=jm, in_specs=(P(AXIS),) * 5,
                              out_specs=P(AXIS)))
    ref = f(*_jshard(jm, keys, vals, fvals, valid, key_valid))
    sh = [t_mesh.shard(tm, x) for x in (keys, vals, fvals, valid,
                                        key_valid)]
    got = t_ops.dist_hash_aggregate(
        sh[0], sh[3], {"v": (sh[1], None), "f": (sh[2], None)}, aggs, tm,
        capacity=4 * nper, key_valid=sh[4], max_groups=128)
    _same(ref["group_count"], got["group_count"], "group counts",
          widths=False)
    _same(ref["overflow"], got["overflow"], "overflow")
    names = ["agg:v:sum", "agg:v:count", "agg:v:min", "agg:v:max",
             "agg:f:sum", "key_is_null"]
    G = 129
    for p in range(NDEV):
        r_cols = [_per_part(ref[n])[p] for n in names]
        t_cols = [got[n][p].numpy() for n in names]
        rg = _groups(_per_part(ref["keys"])[p], _per_part(
            ref["group_count"])[p][0], r_cols)
        tg = _groups(got["keys"][p], got["group_count"][p], t_cols)
        assert rg.keys() == tg.keys(), f"partition {p}: key sets differ"
        for k in rg:
            assert rg[k][:4] + rg[k][5:] == tg[k][:4] + tg[k][5:], (p, k)
            np.testing.assert_allclose(tg[k][4], rg[k][4], rtol=1e-12)
    # and against a plain oracle: each key on one partition
    merged = {}
    for p in range(NDEV):
        gk = got["keys"][p].numpy()
        for i in range(int(got["group_count"][p])):
            if got["key_is_null"][p][i]:
                continue
            assert int(gk[i]) not in merged
            merged[int(gk[i])] = int(got["agg:v:sum"][p][i])
    kept = valid & key_valid
    assert merged == {int(k): int(vals[kept & (keys == k)].sum())
                      for k in np.unique(keys[kept])}


def _join_inputs(seed=1, nper=256, build_per=64):
    rng = np.random.default_rng(seed)
    total, btotal = nper * NDEV, build_per * NDEV
    probe = rng.integers(0, 300, total).astype(np.int64)
    pv = rng.integers(0, 1000, total).astype(np.int64)
    build = rng.permutation(2000)[:btotal].astype(np.int64)
    bv = rng.integers(0, 1000, btotal).astype(np.int64)
    return probe, pv, build, bv


def _join_rows(cols, row_ok, p, names):
    """Partition p's output rows as sorted tuples (None for a null)."""
    ok = row_ok[p].numpy()
    rows = []
    for i in np.nonzero(ok)[0]:
        rows.append(tuple(int(cols[n][0][p][i]) if cols[n][1][p][i]
                          else None for n in names))
    return sorted(rows, key=str)


@pytest.mark.parametrize("how", ["inner", "left", "semi"])
def test_dist_join_matches_reference(meshes, how):
    jm, tm = meshes
    nper, build_per = 256, 64
    probe, pv, build, bv = _join_inputs()
    names = ["__probe_key", "pv"] + ([] if how == "semi" else ["bv"])

    def step(pk, pvv, bk, bvv):
        res, cols, row_ok, overflow = j_ops.dist_join(
            pk, jnp.ones_like(pk, dtype=bool), {"pv": (pvv, None)},
            bk, jnp.ones_like(bk, dtype=bool), {"bv": (bvv, None)},
            AXIS, probe_capacity=4 * nper, build_capacity=4 * build_per,
            out_capacity=8 * nper, how=how)
        out = [res.probe_idx, res.build_idx, res.count[None], row_ok,
               overflow[None]]
        for n in names:
            out += [cols[n][0], cols[n][1]]
        return tuple(out)

    f = jax.jit(jax.shard_map(step, mesh=jm, in_specs=(P(AXIS),) * 4,
                              out_specs=(P(AXIS),) * (5 + 2 * len(names))))
    ref = f(*_jshard(jm, probe, pv), *_jshard(jm, build, bv))
    sh = [t_mesh.shard(tm, x) for x in (probe, pv, build, bv)]
    ones = [torch.ones_like(x, dtype=torch.bool) for x in sh[0]]
    bones = [torch.ones_like(x, dtype=torch.bool) for x in sh[2]]
    res, cols, row_ok, overflow = t_ops.dist_join(
        sh[0], ones, {"pv": (sh[1], None)}, sh[2], bones,
        {"bv": (sh[3], None)}, tm, probe_capacity=4 * nper,
        build_capacity=4 * build_per, out_capacity=8 * nper, how=how)
    _same(ref[2], [r.count for r in res], "counts")
    _same(ref[4], overflow, "overflow")
    assert not any(bool(o) for o in overflow)
    counts = [int(r.count) for r in res]
    for p in range(NDEV):
        c = counts[p]
        np.testing.assert_array_equal(res[p].probe_idx[:c].numpy(),
                                      _per_part(ref[0])[p][:c])
        np.testing.assert_array_equal(res[p].build_idx[:c].numpy(),
                                      _per_part(ref[1])[p][:c])
    _same(ref[3], row_ok, "row_ok")
    for j, n in enumerate(names):
        vals, valid = _per_part(ref[5 + 2 * j]), _per_part(ref[6 + 2 * j])
        for p in range(NDEV):
            ok = _port(row_ok)[p]
            np.testing.assert_array_equal(_port(cols[n][1])[p][ok],
                                          valid[p][ok], err_msg=n)
            live = ok & valid[p]
            np.testing.assert_array_equal(_port(cols[n][0])[p][live],
                                          vals[p][live], err_msg=n)
    # against Acero, globally
    how_map = {"inner": "inner", "left": "left outer", "semi": "left semi"}
    ores = pa.table({"k": probe, "pv": pv}).join(
        pa.table({"k": build, "bv": bv}), keys="k",
        join_type=how_map[how], coalesce_keys=False).to_pylist()
    got = sorted((r for p in range(NDEV)
                  for r in _join_rows(cols, row_ok, p, names[1:])), key=str)
    want = sorted((tuple(r[n] for n in names[1:]) for r in ores), key=str)
    assert got == want


def _sort_inputs(seed, nper=256, skew=False):
    rng = np.random.default_rng(seed)
    total = nper * NDEV
    if skew:
        keys = (rng.zipf(1.3, total) % 1000).astype(np.int64)
        null = np.zeros(total, dtype=bool)
    else:
        keys = rng.integers(-10000, 10000, total).astype(np.int64)
        null = rng.random(total) < 0.08
    return keys, np.arange(total, dtype=np.int64), null


@pytest.mark.parametrize("case", ["nulls_first", "nulls_last", "skewed",
                                  "descending"])
def test_dist_sort_matches_reference(meshes, case):
    jm, tm = meshes
    nper = 256
    keys, payload, null = _sort_inputs(5 if case == "skewed" else 2,
                                       skew=case == "skewed")
    nulls_first = case != "nulls_last"
    ascending = case != "descending"
    cap = (8 if case == "skewed" else 4) * nper

    def run(k, pl, notnull):
        return j_ops.dist_sort(k, notnull, {"p": (pl, None)}, AXIS,
                               capacity=cap, ascending=ascending,
                               nulls_first=nulls_first)

    f = jax.jit(jax.shard_map(run, mesh=jm, in_specs=(P(AXIS),) * 3,
                              out_specs=(P(AXIS),) * 4 + (P(),)))
    rk, rvalid, rnull, rpay, rov = f(*_jshard(jm, keys, payload, ~null))
    sh = [t_mesh.shard(tm, x) for x in (keys, payload, ~null)]
    tk, tvalid, tnull, tpay, tov = t_ops.dist_sort(
        sh[0], sh[2], {"p": (sh[1], None)}, tm, capacity=cap,
        ascending=ascending, nulls_first=nulls_first)
    assert bool(tov) == bool(rov)
    assert not bool(tov)
    _same(rk, tk, "keys")
    _same(rvalid, tvalid, "row validity")
    _same(rnull, tnull, "null flags")
    _same(rpay["p"][0], tpay["p"][0], "payload")
    # globally sorted, nulls at the requested end
    k, ok, nl = _port(tk).ravel(), _port(tvalid).ravel(), _port(tnull).ravel()
    nn = ok & ~nl
    expect = np.sort(keys[~null], kind="stable")
    np.testing.assert_array_equal(k[nn], expect if ascending
                                  else expect[::-1])
    assert (ok & nl).sum() == null.sum()


def test_detect_hot_keys_matches_reference(meshes):
    jm, tm = meshes
    nper = 4096
    rng = np.random.default_rng(11)
    keys = (rng.zipf(1.3, nper * NDEV) % 5000).astype(np.int64)
    valid = rng.random(nper * NDEV) < 0.95
    for num_hot in (4, 16, 64):
        def step(k, ok, _h=num_hot):
            hk, hv = j_ops.detect_hot_keys(k, ok, AXIS, _h)
            return hk, hv

        f = jax.jit(jax.shard_map(step, mesh=jm, in_specs=(P(AXIS),) * 2,
                                  out_specs=(P(AXIS),) * 2))
        rk, rv = f(*_jshard(jm, keys, valid))
        sh = [t_mesh.shard(tm, x) for x in (keys, valid)]
        tk, tv = t_ops.detect_hot_keys(sh[0], sh[1], tm, num_hot)
        for p in range(NDEV):      # every shard holds the same table
            np.testing.assert_array_equal(tk.numpy(), _per_part(rk)[p])
            np.testing.assert_array_equal(tv.numpy(), _per_part(rv)[p])
        assert bool(tv.any())


_EDGE = [-(1 << 63), (1 << 63) - 1, 0, -1]


@pytest.mark.parametrize("entries,valid", [
    (1, "all"), (8, "none"), (8, "mixed"), (64, "mixed"), (64, "all"),
    (65, "mixed")])
def test_is_in_table_matches_reference(entries, valid):
    """Hot-key membership on CPU tensors against the reference's broadcast
    compare: the edge keys and a repeated entry in the table, an invalid
    entry equal to keys that are present. The route is the plain one (the
    table read on the host, then ``torch.isin``): no kernel launched, no
    ``kernel_rows`` counted."""
    from torch.profiler import ProfilerActivity, profile

    from gandiva_tpu_torch import tracing
    from gandiva_tpu_torch.ops.kernels import LAUNCHES, reset_launches

    rng = np.random.default_rng(entries)
    table = rng.integers(-(1 << 62), 1 << 62, entries)
    table[:min(entries, 4)] = _EDGE[:min(entries, 4)]
    if entries >= 8:
        table[-1] = table[4]
    ok = {"none": np.zeros(entries, bool), "all": np.ones(entries, bool),
          "mixed": np.arange(entries) % 3 != 1}[valid]
    keys = np.concatenate([rng.choice(table, 3000),
                           rng.integers(-(1 << 62), 1 << 62, 3000),
                           _EDGE, table + 1])
    want = np.asarray(j_ops._is_in_table(jnp.asarray(keys),
                                         jnp.asarray(table),
                                         jnp.asarray(ok)))
    reset_launches()
    tracing.clear()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            with tracing.span("gt.join.hot_keys"):
                got = t_ops._is_in_table(torch.from_numpy(keys),
                                         torch.from_numpy(table),
                                         torch.from_numpy(ok))
        spans = tracing.spans()
    finally:
        tracing.clear()
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.any() == (valid != "none")
    assert not any(LAUNCHES.values())
    assert [s.counters for s in spans if s.name == "gt.join.hot_keys"] \
        == [{}]
    assert {"gt.sync.hot_table", "gt.sync.hot_isin"} <= \
        {s.name for s in spans}


def _key_table_args(case):
    """(keys, table, table_valid) that break one of ``is_in_table_cuda``'s
    conditions each, none on a CUDA card."""
    from gandiva_tpu_torch.ops.kernels.key_table import MAX_ENTRIES

    keys = torch.arange(16, dtype=torch.int64)
    table = torch.arange(4, dtype=torch.int64)
    ok = torch.ones(4, dtype=torch.bool)
    if case == "keys_int32":
        keys = keys.to(torch.int32)
    elif case == "keys_2d":
        keys = keys.reshape(4, 4)
    elif case == "table_int32":
        table = table.to(torch.int32)
    elif case == "valid_uint8":
        ok = ok.to(torch.uint8)
    elif case == "valid_short":
        ok = ok[:3]
    elif case == "table_over_limit":
        table = torch.arange(MAX_ENTRIES + 1, dtype=torch.int64)
        ok = torch.ones(MAX_ENTRIES + 1, dtype=torch.bool)
    elif case == "keys_strided":
        keys = keys[::2]
    elif case == "devices_differ":
        table = torch.empty(4, dtype=torch.int64, device="meta")
    return keys, table, ok


@pytest.mark.parametrize("case,match", [
    ("cpu", "CUDA"), ("keys_int32", "int64"), ("keys_2d", "int64"),
    ("table_int32", "int64"), ("valid_uint8", "bool"),
    ("valid_short", "bool"), ("table_over_limit", "1024"),
    ("keys_strided", "contiguous"), ("devices_differ", "one device")])
def test_key_table_kernel_refuses_what_it_does_not_take(monkeypatch, case,
                                                        match):
    """``is_in_table_cuda`` checks its arguments before it loads
    csrc/key_table.cu or launches: CPU tensors, the wrong dtype or shape,
    a table past its limit, a strided view and tensors on two devices
    raise with what was wrong."""
    from gandiva_tpu_torch.ops.kernels import key_table

    def refuse(*_args, **_kwargs):
        raise AssertionError("the key table's library was loaded")

    monkeypatch.setattr(key_table, "library", refuse)
    with pytest.raises(ValueError, match=match):
        key_table.is_in_table_cuda(*_key_table_args(case))


def _skewed_inputs(nper=512, build_per=32, null_frac=0.0):
    rng = np.random.default_rng(11)
    total, btotal = nper * NDEV, build_per * NDEV
    probe = (rng.zipf(1.3, total) % 200).astype(np.int64)
    pv = rng.integers(0, 1000, total).astype(np.int64)
    build = rng.permutation(400)[:btotal].astype(np.int64)
    bv = rng.integers(0, 1000, btotal).astype(np.int64)
    bvalid = rng.random(btotal) >= null_frac
    return probe, pv, build, bv, bvalid


def _port_skewed(tm, how, probe, pv, build, bv, bvalid, nper, build_per):
    sh = [t_mesh.shard(tm, x) for x in (probe, pv, build, bv, bvalid)]
    ones = [torch.ones_like(x, dtype=torch.bool) for x in sh[0]]
    return t_ops.dist_join_skewed(
        sh[0], ones, {"pv": (sh[1], None)}, sh[2], sh[4],
        {"bv": (sh[3], None)}, tm, probe_capacity=3 * nper,
        build_capacity=4 * build_per, out_capacity=4 * nper, how=how,
        num_hot=16, hot_replicate_capacity=64)


@pytest.mark.parametrize("how", ["inner", "semi", "right", "full"])
def test_dist_join_skewed_matches_reference(meshes, how):
    jm, tm = meshes
    nper, build_per = 512, 32
    probe, pv, build, bv, bvalid = _skewed_inputs(nper, build_per)

    def step(pk, pvv, bk, bvv):
        res, cols, row_ok, overflow = j_ops.dist_join_skewed(
            pk, jnp.ones_like(pk, dtype=bool), {"pv": (pvv, None)},
            bk, jnp.ones_like(bk, dtype=bool), {"bv": (bvv, None)},
            AXIS, probe_capacity=3 * nper, build_capacity=4 * build_per,
            out_capacity=4 * nper, how=how, num_hot=16,
            hot_replicate_capacity=64)
        pvo, pvok = cols["pv"]
        bvo, bvok = cols.get("bv", (jnp.zeros_like(pvo), row_ok))
        return (res.probe_idx, res.build_idx, res.count[None], pvo, pvok,
                bvo, bvok, row_ok, overflow[None])

    f = jax.jit(jax.shard_map(step, mesh=jm, in_specs=(P(AXIS),) * 4,
                              out_specs=(P(AXIS),) * 9))
    ref = f(*_jshard(jm, probe, pv), *_jshard(jm, build, bv))
    res, cols, row_ok, overflow = _port_skewed(tm, how, probe, pv, build,
                                               bv, bvalid, nper, build_per)
    _same(ref[2], [r.count for r in res], "counts")
    _same(ref[8], overflow, "overflow")
    assert not any(bool(o) for o in overflow)
    for p in range(NDEV):
        c = int(res[p].count)
        np.testing.assert_array_equal(res[p].probe_idx[:c].numpy(),
                                      _per_part(ref[0])[p][:c])
        np.testing.assert_array_equal(res[p].build_idx[:c].numpy(),
                                      _per_part(ref[1])[p][:c])
    _same(ref[7], row_ok, "row_ok")
    names = ["pv"] + ([] if how == "semi" else ["bv"])
    for j, n in enumerate(names):
        rvals, rvalid = _per_part(ref[3 + 2 * j]), _per_part(ref[4 + 2 * j])
        ok = _port(row_ok)
        np.testing.assert_array_equal(_port(cols[n][1])[ok], rvalid[ok],
                                      err_msg=n)
        live = ok & rvalid
        np.testing.assert_array_equal(_port(cols[n][0])[live], rvals[live],
                                      err_msg=n)


@pytest.mark.parametrize("how", ["right", "full"])
def test_dist_join_skewed_keeps_null_build_keys(meshes, how):
    """A reference fault not copied: its right/full skewed join drops build
    rows whose key is null (``gandiva_tpu/parallel/ops.py:272``); the port
    emits them as unmatched on their origin partition, as Acero does."""
    _, tm = meshes
    nper, build_per = 512, 32
    probe, pv, build, bv, bvalid = _skewed_inputs(nper, build_per,
                                                  null_frac=0.2)
    res, cols, row_ok, overflow = _port_skewed(tm, how, probe, pv, build,
                                               bv, bvalid, nper, build_per)
    assert not any(bool(o) for o in overflow)
    got = sorted((r for p in range(NDEV)
                  for r in _join_rows(cols, row_ok, p, ["pv", "bv"])),
                 key=str)
    bt = pa.table({"k": pa.array(build, mask=~bvalid), "bv": bv})
    ores = pa.table({"k": probe, "pv": pv}).join(
        bt, keys="k", join_type={"right": "right outer",
                                 "full": "full outer"}[how],
        coalesce_keys=False).to_pylist()
    want = sorted(((r["pv"], r["bv"]) for r in ores), key=str)
    assert (~bvalid).sum() > 0
    assert got == want


# ---------------------------------------------------------------------------
# the pipeline (BASELINE configs[4])
# ---------------------------------------------------------------------------

def _pipeline_inputs(seed=123, nper=1024, build_per=64, segs=7):
    rng = np.random.default_rng(seed)
    total, btotal = nper * NDEV, build_per * NDEV
    orders_key = (rng.zipf(1.4, total) % (btotal * 2)).astype(np.int64)
    orders_amt = rng.integers(1, 100, total).astype(np.int64)
    dim_key = rng.permutation(btotal * 2)[:btotal].astype(np.int64)
    dim_seg = rng.integers(0, segs, btotal).astype(np.int64)
    return orders_key, orders_amt, dim_key, dim_seg


def _acero_pipeline(orders_key, orders_amt, dim_key, dim_seg, threshold=50):
    orders = pa.table({"k": orders_key, "amt": orders_amt})
    dim = pa.table({"k": dim_key, "seg": dim_seg})
    filt = orders.filter(pc.greater(orders.column("amt"), threshold))
    joined = filt.join(dim, keys="k", join_type="inner")
    agg = joined.group_by("seg").aggregate([("amt", "sum"),
                                            ("amt", "count")])
    return (sorted((r["seg"], r["amt_sum"], r["amt_count"])
                   for r in agg.to_pylist()), joined.num_rows)


def test_pipeline_matches_reference_and_acero(meshes):
    jm, tm = meshes
    nper, build_per = 1024, 64
    inputs = _pipeline_inputs()
    jfn = j_pipe.build_filter_join_agg_sort(jm, nper, build_per,
                                            num_groups=16,
                                            filter_threshold=50)
    rkeys, rsums, rcounts, rmetrics = j_pipe.run_pipeline(jfn, *inputs, jm)
    tfn = t_pipe.build_filter_join_agg_sort(tm, num_groups=16,
                                            filter_threshold=50)
    assert t_pipe.build_filter_join_agg_sort(
        tm, num_groups=16, filter_threshold=50) is tfn
    keys, sums, counts, metrics = t_pipe.run_pipeline(tfn, *inputs, tm)
    np.testing.assert_array_equal(keys, rkeys)
    np.testing.assert_array_equal(sums, rsums)
    np.testing.assert_array_equal(counts, rcounts)
    for k in ("rows_in", "filter_out", "join_out", "agg_groups",
              "bytes_shuffled"):
        assert metrics[k] == rmetrics[k], k
    want, joined_rows = _acero_pipeline(*inputs)
    assert sorted(zip(keys.tolist(), sums.tolist(), counts.tolist())) == want
    assert list(keys) == sorted(keys)
    assert metrics["rows_in"] == nper * NDEV
    assert metrics["join_out"] == joined_rows
    assert metrics["wall_time_s"] > 0 and metrics["rows_per_s"] > 0


def test_pipeline_overflow_retry_recovers(meshes):
    """test_pipeline.py::test_pipeline_overflow_retry_recovers on the
    port, on the capacities that are still guesses: the exchanges are
    sized by the rows that move, so 80% of the orders on two keys overflow
    none of them (the reference's ``shuffle_factor`` 1 does), but the two
    keys' build rows, hot and on one partition, overflow a hot capacity of
    1, and seven segments overflow one group a partition; the retry loop
    must double both and match the oracle."""
    _, tm = meshes
    nper, build_per = 512, 32
    rng = np.random.default_rng(7)
    total, btotal = nper * NDEV, build_per * NDEV
    dim_key = rng.permutation(btotal * 2)[:btotal].astype(np.int64)
    u = rng.random(total)
    orders_key = np.where(u < 0.4, dim_key[0], np.where(
        u < 0.8, dim_key[1], rng.integers(0, btotal * 2, total))).astype(
            np.int64)
    orders_amt = rng.integers(1, 100, total).astype(np.int64)
    dim_seg = rng.integers(0, 7, btotal).astype(np.int64)
    inputs = (orders_key, orders_amt, dim_key, dim_seg)
    for groups, hot in ((16, 1), (1, 64)):
        fn = t_pipe.build_filter_join_agg_sort(
            tm, num_groups=groups, filter_threshold=50, num_hot=8,
            hot_capacity=hot)
        with pytest.raises(t_pipe.PipelineOverflowError):
            t_pipe.run_pipeline(fn, *inputs, tm)
    keys, sums, counts, metrics = t_pipe.run_pipeline_with_retry(
        tm, *inputs, num_groups=1, filter_threshold=50, num_hot=8,
        hot_capacity=1)
    assert metrics["retries"] >= 1
    assert metrics["num_groups"] > 1 and metrics["hot_capacity"] > 1
    want, _ = _acero_pipeline(*inputs)
    assert sorted(zip(keys.tolist(), sums.tolist(), counts.tolist())) == want


def test_scaling_harnesses_return_their_rows():
    """test_pipeline.py::test_scaling_efficiency_harness on the port, and
    the weak-scaling harness: every row names its partition and card
    counts and its baseline."""
    counts = [1, 2, 4]
    strong = t_pipe.measure_scaling_efficiency(
        counts, total_rows=1024 * 4, total_build=128 * 4, num_groups=16,
        repeats=1, device="cpu", num_hot=8, hot_capacity=32)
    weak = t_pipe.measure_weak_scaling(
        [2, 4], rows_per_shard=512, build_per_shard=64, num_groups=16,
        repeats=1, device="cpu", num_hot=8, hot_capacity=32)
    assert [r["n_partitions"] for r in strong] == counts
    assert [r["n_partitions"] for r in weak] == [2, 4]
    for rows, base in ((strong, 1), (weak, 2)):
        for r in rows:
            assert r["wall_s"] > 0 and r["rows_per_s"] > 0
            assert r["efficiency"] > 0
            assert r["n_cards"] == 0               # partitions of the CPU
            assert r["baseline_partitions"] == base
        assert rows[0]["efficiency"] == pytest.approx(1.0)


def test_model_ici_efficiency_takes_no_tpu_constant():
    metrics = {"rows_in": 1_000_000, "filter_out": 500_000,
               "join_out": 400_000, "bytes_shuffled": 12_000_000,
               "wall_time_s": 0.01}
    m = t_pipe.model_ici_efficiency(metrics, 4)
    hbm = 16.0 * (1_000_000 + 500_000 + 800_000) / 4
    assert m["t_compute_s"] == pytest.approx(hbm / 3.35e12)
    assert m["t_comm_s"] == pytest.approx(12e6 / 4 * 3 / 4 / 4.5e11)
    assert m["t_compute_measured_s"] == pytest.approx(0.01 / 4)
    slow = t_pipe.model_ici_efficiency(metrics, 4, link_bytes_per_s=1e6)
    assert slow["efficiency_overlapped"] < m["efficiency_overlapped"]
    for v in m.values():
        assert np.isfinite(v)


def test_distributed_step_matches_reference(meshes):
    from gandiva_tpu import entrypoints as j_entry
    from gandiva_tpu_torch import entrypoints as t_entry

    jm, tm = meshes
    nper = 1024
    total = nper * NDEV
    rng = np.random.default_rng(4)
    keys = rng.integers(0, 1000, total).astype(np.int64)
    vals = rng.random(total)
    valid = rng.random(total) >= 0.05
    cap, G = nper, 256
    jfn = j_entry.distributed_step(jm, cap, num_groups=G)
    rk, rs, rc, rgc, rtotal, rov = jfn(*_jshard(jm, keys, vals, valid))
    tfn = t_entry.distributed_step(tm, cap, num_groups=G)
    sh = [t_mesh.shard(tm, x) for x in (keys, vals, valid)]
    tk, ts, tc, tgc, ttotal, tov = tfn(*sh)
    assert int(ttotal) == int(rtotal)
    assert bool(tov) == bool(rov) is False
    _same(rgc, tgc, "group counts", widths=False)
    for p in range(NDEV):
        rg = _groups(_per_part(rk)[p], _per_part(rgc)[p][0],
                     [_per_part(rs)[p], _per_part(rc)[p]])
        tg = _groups(tk[p], tgc[p], [ts[p].numpy(), tc[p].numpy()])
        assert rg.keys() == tg.keys()
        for k in rg:
            assert rg[k][1] == tg[k][1]
            np.testing.assert_allclose(tg[k][0], rg[k][0], rtol=1e-12)
    # against pyarrow's group_by on the filtered rows
    keep = valid & (keys > 500)
    want = pa.table({"k": keys[keep], "v": vals[keep] * 2.0
                     + keys[keep].astype(np.float64)}).group_by("k") \
        .aggregate([("v", "sum"), ("v", "count")]).to_pylist()
    got = {}
    for p in range(NDEV):
        for i in range(int(tgc[p])):
            got[int(tk[p][i])] = (float(ts[p][i]), int(tc[p][i]))
    assert got.keys() == {r["k"] for r in want}
    for r in want:
        assert got[r["k"]][1] == r["v_count"]
        np.testing.assert_allclose(got[r["k"]][0], r["v_sum"], rtol=1e-12)


def test_new_entry_points_default_to_the_card(monkeypatch):
    from gandiva_tpu_torch import entrypoints as t_entry

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_mesh.make_mesh(4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_pipe.measure_scaling_efficiency([1], 1024, 128, repeats=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_pipe.measure_weak_scaling([1], 1024, 128, repeats=1)
    mesh = t_mesh.make_mesh(4, device="cpu")
    assert mesh.device.type == "cpu" and mesh.local == 4
    assert callable(t_entry.distributed_step(mesh, 16))
