"""The port's aggregate slice against gandiva_tpu on the CPU: the hashes, the
key normalization, the group-id assignment, segment_reduce and
hash_aggregate (kernel K5's plain version, which CPU tensors take, and the
generic torch path), on the same inputs made with numpy from a seed.

JAX's Pallas aggregate runs as the reference's own tests run it on the CPU
(``backend="pallas_interpret"``). Tolerances:
- integers, counts, keys and integer min/max: bit-exact;
- float min/max against JAX ``xla``: bit-exact (no NaN in those inputs);
  against JAX ``pallas_interpret``, f64 within rtol 1e-13, because that
  path decodes f64 from hi+lo f32 planes, about 48 bits;
- f64 sums and means: rtol 1e-12 against JAX ``xla`` (the same addends in
  another order); rtol 1e-6 against JAX ``pallas_interpret``, whose f32
  planes are good to about 1e-7;
- f32 sums: rtol 1e-5 (the port sums f32 in f64, JAX in f32), relative
  to the sum of magnitudes where the sums cancel;
- NaN and ±0.0 in min/max follow the pyarrow oracle.
"""
import functools
import importlib

import numpy as np
import pyarrow as pa
import pytest
import torch

import jax.numpy as jnp

from gandiva_tpu.ops import groupby as j_groupby
from gandiva_tpu.ops import sort as j_sort
from gandiva_tpu.utils import hashing as j_hash
from gandiva_tpu_torch.ops import groupby as t_groupby
from gandiva_tpu_torch.ops import sort as t_sort
from gandiva_tpu_torch.ops.kernels import LAUNCHES, reset_launches
from gandiva_tpu_torch.ops.kernels import aggregate as k5
from gandiva_tpu_torch.utils import hashing as t_hash

# the ops packages export the function hash_aggregate under the module's name
j_agg = importlib.import_module("gandiva_tpu.ops.hash_aggregate")
t_agg = importlib.import_module("gandiva_tpu_torch.ops.hash_aggregate")
I64_MIN, I64_MAX = -2**63, 2**63 - 1
_JNP = {np.dtype(d): d for d in (jnp.bool_, jnp.int8, jnp.int16, jnp.int32,
                                 jnp.int64, jnp.uint8, jnp.uint16,
                                 jnp.uint32, jnp.uint64, jnp.float32,
                                 jnp.float64)}
_TORCH = {np.dtype(np.bool_): torch.bool, np.dtype(np.int8): torch.int8,
          np.dtype(np.int16): torch.int16, np.dtype(np.int32): torch.int32,
          np.dtype(np.int64): torch.int64, np.dtype(np.uint8): torch.uint8,
          np.dtype(np.uint16): torch.uint16,
          np.dtype(np.uint32): torch.uint32,
          np.dtype(np.uint64): torch.uint64,
          np.dtype(np.float32): torch.float32,
          np.dtype(np.float64): torch.float64}
DTYPES = list(_TORCH)


def _t(x):
    return None if x is None else torch.from_numpy(np.ascontiguousarray(x))


def _j(x):
    return None if x is None else jnp.asarray(x)


def _column(dt, n, rng):
    """n values of ``dt`` over its whole range, with the edge values."""
    dt = np.dtype(dt)
    if dt == np.bool_:
        return rng.random(n) < 0.5
    if dt.kind == "f":
        x = (rng.standard_normal(n) * 1e3).astype(dt)
        edge = np.array([0.0, -0.0, np.nan, np.inf, -np.inf, 1.5, -1.5,
                         np.finfo(dt).max, np.finfo(dt).tiny], dt)
    else:
        info = np.iinfo(dt)
        x = rng.integers(info.min, info.max, n, dtype=dt, endpoint=True)
        edge = np.array([info.min, info.max, 0, 1], dt)
    x[:len(edge)] = edge
    return x


# ---------------------------------------------------------------------------
# utils/hashing.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dt", DTYPES, ids=str)
def test_hash32_hash64_bit_exact(dt):
    rng = np.random.default_rng(1)
    x = _column(dt, 2000, rng)
    y = _column(np.int32, 2000, rng)
    for seed in (0, 0x9E37, 0xFFFF_FFFF):
        want = np.asarray(j_hash.hash32(_j(x), jnp.uint32(seed)))
        got = np.asarray(t_hash.hash32(_t(x), seed))
        assert got.dtype == np.int64 and got.min() >= 0 and got.max() < 2**32
        np.testing.assert_array_equal(got.astype(np.uint32), want)
    # chained: a tensor seed
    want = np.asarray(j_hash.hash32(_j(y), j_hash.hash32(_j(x))))
    got = np.asarray(t_hash.hash32(_t(y), t_hash.hash32(_t(x))))
    np.testing.assert_array_equal(got.astype(np.uint32), want)
    for seed in (0, 0x1234_5678_9ABC_DEF0, 2**64 - 1):
        want = np.asarray(j_hash.hash64(_j(x), jnp.uint64(seed)))
        bits = seed - 2**64 if seed >= 2**63 else seed
        got = np.asarray(t_hash.hash64(_t(x), bits))
        np.testing.assert_array_equal(got.view(np.uint64), want)


# ---------------------------------------------------------------------------
# ops/sort.py: key normalization
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ascending", [True, False])
@pytest.mark.parametrize("dt", DTYPES, ids=str)
def test_normalize_denormalize_bit_exact(dt, ascending):
    x = _column(dt, 3000, np.random.default_rng(2))
    want = np.asarray(j_sort.normalize_key(_j(x), ascending))
    got = t_sort.normalize_key(_t(x), ascending)
    assert got.element_size() == want.itemsize
    np.testing.assert_array_equal(np.asarray(got).view(want.dtype), want)
    back_want = np.asarray(j_sort.denormalize_key(_j(want), _JNP[np.dtype(dt)],
                                                  ascending))
    back = np.asarray(t_sort.denormalize_key(got, _TORCH[np.dtype(dt)],
                                             ascending))
    assert back.dtype == back_want.dtype
    if back.dtype.kind == "f":  # bit patterns: canonical -0.0 and NaN
        back, back_want = back.view(np.int64 if back.itemsize == 8
                                    else np.int32), \
            back_want.view(np.int64 if back.itemsize == 8 else np.int32)
    np.testing.assert_array_equal(back, back_want)


# ---------------------------------------------------------------------------
# ops/groupby.py
# ---------------------------------------------------------------------------

def _same_partition(got_gid, want_gid, rows):
    """Equal gids ⟺ equal gids, on ``rows``."""
    g, w = got_gid[rows], want_gid[rows]
    pairs = set(zip(g.tolist(), w.tolist()))
    assert len(pairs) == len(set(g.tolist())) == len(set(w.tolist()))


def _keys(kind, n, rng):
    if kind == "int64":
        return rng.integers(-50, 50, n) * 10**12
    if kind == "int32":
        return rng.integers(-40, 40, n).astype(np.int32)
    if kind == "uint64":
        return (rng.integers(0, 30, n).astype(np.uint64)
                * np.uint64(2**59) + np.uint64(7))
    if kind == "uint32":
        return rng.integers(2**32 - 40, 2**32, n).astype(np.uint32)
    if kind == "float64":
        k = rng.integers(-20, 20, n) / 4.0
        k[:4] = [0.0, -0.0, np.nan, -np.nan]
        return k
    if kind == "float32":
        k = (rng.integers(-20, 20, n) / 4.0).astype(np.float32)
        k[:3] = [0.0, -0.0, np.nan]
        return k
    if kind == "bool":
        return rng.random(n) < 0.3
    raise ValueError(kind)


KEY_KINDS = ["int64", "int32", "uint64", "uint32", "float64", "float32",
             "bool"]


@pytest.mark.parametrize("max_groups", [64, 256])
@pytest.mark.parametrize("kind", KEY_KINDS)
def test_distinct_small_exact(kind, max_groups):
    rng = np.random.default_rng(3)
    n = 3000
    keys = _keys(kind, n, rng)
    if kind == "float64":  # ±0.0 maps to int64::min: see the test below
        keys[keys == 0] = 0.75
    valid = rng.random(n) < 0.9
    for v in (None, valid):
        want = j_groupby.distinct_small(_j(keys), _j(v), max_groups)
        got = t_groupby.distinct_small(_t(keys), _t(v), max_groups)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


@pytest.mark.parametrize("max_groups", [4, 8])
def test_distinct_small_overflow_and_max_key(max_groups):
    """More distinct keys than max_groups, and the int64::max key (which
    takes the gid after the table, as in the reference)."""
    rng = np.random.default_rng(4)
    keys = rng.integers(0, 12, 500)
    keys[::7] = I64_MAX
    for k in (keys, np.where(keys < max_groups, keys, I64_MAX)):
        want = j_groupby.distinct_small(_j(k), None, max_groups)
        got = t_groupby.distinct_small(_t(k), None, max_groups)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_distinct_small_int64_min_key():
    """int64::min is a key like any other in the port, and so is the
    float64 key ±0.0, whose ``key_to_i64`` image it is. (The reference's
    min-extraction starts strictly above int64::min and reports overflow
    for both: ROADMAP §3.4.)"""
    keys = np.array([I64_MIN, 5, I64_MIN, -3, I64_MAX, 5])
    gid, uniq, count, overflow = t_groupby.distinct_small(_t(keys), None, 8)
    assert not bool(overflow) and int(count) == 4
    assert np.asarray(uniq)[:3].tolist() == [I64_MIN, -3, 5]
    assert np.asarray(gid).tolist() == [0, 2, 0, 1, 3, 2]
    fkeys = np.array([0.0, 1.5, -0.0, -2.0])
    gid, uniq, count, overflow = t_groupby.distinct_small(_t(fkeys), None, 8)
    assert not bool(overflow) and int(count) == 3
    assert np.asarray(gid).tolist() == [0, 1, 0, 2]  # int64 image order
    assert bool(j_groupby.distinct_small(_j(fkeys), None, 8)[3])


@pytest.mark.parametrize("nulls", [False, True])
@pytest.mark.parametrize("kind", KEY_KINDS)
def test_group_ids_partition(kind, nulls):
    rng = np.random.default_rng(5)
    n = 4000
    keys = _keys(kind, n, rng)
    valid = (rng.random(n) < 0.85) if nulls else None
    want = j_groupby.group_ids(_j(keys), _j(valid), max_groups=128)
    got = t_groupby.group_ids(_t(keys), _t(valid), max_groups=128)
    gid, uniq, count, overflow = (np.asarray(x) for x in got)
    wgid, wuniq, wcount, woverflow = (np.asarray(x) for x in want)
    assert gid.dtype == np.int32 and uniq.shape == wuniq.shape
    assert int(count) == int(wcount) and bool(overflow) == bool(woverflow)
    rows = np.ones(n, bool) if valid is None else valid
    T = t_groupby.table_size_for(128)
    assert (gid[~rows] == T).all() and (wgid[~rows] == T).all()
    _same_partition(gid, wgid, rows)
    assert set(uniq[:count].tolist()) == set(wuniq[:wcount].tolist())
    k64 = np.asarray(t_groupby.key_to_i64(_t(keys)))
    np.testing.assert_array_equal(uniq[gid[rows]], k64[rows])


@pytest.mark.parametrize("table_factor,distinct", [(1, 100), (4, 60)])
def test_group_ids_overflow(table_factor, distinct):
    keys = np.arange(distinct, dtype=np.int64) * 1_000_003
    want = j_groupby.group_ids(_j(keys), max_groups=16,
                               table_factor=table_factor)
    got = t_groupby.group_ids(_t(keys), max_groups=16,
                              table_factor=table_factor)
    assert bool(got[3]) == bool(want[3])
    assert int(got[2]) == int(want[2])


@pytest.mark.parametrize("ncols", [1, 2, 3])
def test_group_ids_multi_partition(ncols):
    rng = np.random.default_rng(6)
    n = 3000
    cols = [rng.integers(0, 6, n), rng.integers(-3, 3, n).astype(np.int32),
            rng.integers(0, 5, n) / 2.0][:ncols]
    valids = [None, rng.random(n) < 0.8, rng.random(n) < 0.9][:ncols]
    want = j_groupby.group_ids_multi([_j(c) for c in cols],
                                     [_j(v) for v in valids], max_groups=256)
    got = t_groupby.group_ids_multi([_t(c) for c in cols],
                                    [_t(v) for v in valids], max_groups=256)
    assert int(got[1]) == int(want[1])
    assert bool(got[2]) == bool(want[2]) is False
    _same_partition(np.asarray(got[0]), np.asarray(want[0]),
                    np.ones(n, bool))


# ---------------------------------------------------------------------------
# segment_reduce (one scatter formulation for both of the reference's tiers)
# ---------------------------------------------------------------------------

VALUE_DTYPES = [np.int8, np.int32, np.int64, np.uint8, np.uint16, np.uint32,
                np.uint64, np.float32, np.float64]


@pytest.mark.parametrize("num_groups", [100, 1500], ids=["dense", "scatter"])
@pytest.mark.parametrize("dt", VALUE_DTYPES, ids=lambda d: np.dtype(d).name)
def test_segment_reduce_tiers(dt, num_groups):
    rng = np.random.default_rng(7)
    n = 6000
    # out of range: negative, or past the padded length (the reference's
    # dense tier buckets gids in [num_groups, padded) too: ROADMAP §3.4)
    gid = rng.integers(-5, num_groups, n).astype(np.int32)
    gid[::50] = 10**6
    dt = np.dtype(dt)
    if dt.kind == "f":
        vals = (rng.random(n) * 2e3 - 1e3).astype(dt)
    else:
        vals = _column(dt, n, rng)
    valid = rng.random(n) < 0.8
    for kind in ("sum", "count", "count_all", "min", "max"):
        want = np.asarray(j_agg.segment_reduce(_j(gid), _j(vals), num_groups,
                                               kind, _j(valid)))
        got = np.asarray(t_agg.segment_reduce(_t(gid), _t(vals), num_groups,
                                              kind, _t(valid)))
        assert got.dtype == want.dtype and got.shape == want.shape, kind
        if kind == "sum" and dt.kind == "f":
            # relative to each bucket's sum of magnitudes: these sums cancel
            scale = np.asarray(t_agg.segment_reduce(
                _t(gid), _t(np.abs(vals)), num_groups, kind, _t(valid)))
            rtol = 1e-12 if dt == np.float64 else 1e-5
            assert (np.abs(got.astype(np.float64) - want)
                    <= rtol * scale.astype(np.float64)).all()
        else:
            np.testing.assert_array_equal(got, want, err_msg=kind)
    # in the port, every gid outside [0, num_groups) falls into no bucket
    past = np.full(n, num_groups + 3, np.int32)
    counts = np.asarray(t_agg.segment_reduce(_t(past), _t(vals), num_groups,
                                             "count_all"))
    assert not counts.any()


# ---------------------------------------------------------------------------
# hash_aggregate against JAX's xla and pallas_interpret backends
# ---------------------------------------------------------------------------

def _case(name):
    """(keys, aggs, values, key_valid, kwargs, jax pallas too?) per case."""
    rng = np.random.default_rng(abs(hash(name)) % 2**32)
    n = 4000
    full = [("v", "sum"), ("v", "count"), ("v", "min"), ("v", "max"),
            ("v", "mean"), ("v", "count_all")]
    if name == "nulls_64":
        keys = rng.integers(0, 60, n) * 7 + 3
        # positive values: no cancellation, so rtol on the sums is sound
        vals = {"v": (rng.random(n) * 100, rng.random(n) < 0.9),
                "w": (rng.integers(-10**6, 10**6, n).astype(np.int32), None)}
        aggs = full + [("w", "min"), ("w", "max"), ("w", "sum")]
        return keys, aggs, vals, rng.random(n) < 0.9, dict(max_groups=64), \
            True
    if name == "null_keys_dropped_8":
        keys = rng.integers(0, 8, n)
        vals = {"v": (rng.integers(-99, 99, n).astype(np.int16),
                      rng.random(n) < 0.8)}
        return keys, full, vals, rng.random(n) < 0.8, \
            dict(max_groups=8, group_null_keys=False), False
    if name == "unsigned_8":
        keys = rng.integers(0, 5, n).astype(np.int32)
        vals = {f"u{b}": (_column(np.dtype(f"uint{b}"), n, rng), None)
                for b in (8, 16, 32, 64)}
        aggs = [(c, k) for c in vals for k in ("sum", "min", "max", "mean",
                                               "count")]
        return keys, aggs, vals, None, dict(max_groups=8), True
    if name == "wrap_512":
        keys = rng.integers(0, 500, n)
        big = rng.integers(2**61, 2**62, n) * rng.choice([-1, 1], n)
        vals = {"v": (big, rng.random(n) < 0.95)}
        return keys, full, vals, None, dict(max_groups=512), False
    if name == "g1024":
        keys = rng.integers(-500, 500, n)
        vals = {"f": ((rng.random(n) * 10).astype(np.float32), None),
                "s": (rng.integers(-300, 300, n).astype(np.int16),
                      rng.random(n) < 0.9)}
        aggs = [("f", "sum"), ("f", "min"), ("f", "max"), ("s", "sum"),
                ("s", "min"), ("s", "max"), ("s", "mean"), ("s", "count")]
        return keys, aggs, vals, rng.random(n) < 0.95, \
            dict(max_groups=1024), False
    if name == "overflow_64":
        keys = rng.integers(0, 300, n)
        vals = {"v": (rng.random(n), None)}
        return keys, full, vals, None, dict(max_groups=64), True
    if name == "count_all_only":
        keys = rng.integers(0, 30, n)
        return keys, [("v", "count_all")], {}, rng.random(n) < 0.9, \
            dict(max_groups=64), False
    if name == "uint64_keys":
        keys = (rng.integers(0, 12, n).astype(np.uint64) * np.uint64(2**60)
                + np.uint64(1))
        vals = {"v": (rng.integers(-100, 100, n).astype(np.int8), None)}
        return keys, full, vals, None, dict(max_groups=16), False
    if name == "beyond_f32_range":
        keys = rng.integers(0, 4, 2048)
        vals = {"v": (rng.choice([1e300, -1e308, 1e-310, 2.5e-320, 3.0],
                                 2048), None)}
        return keys, [("v", "sum"), ("v", "min"), ("v", "max")], vals, \
            None, dict(max_groups=8), True
    raise ValueError(name)


CASES = ["nulls_64", "null_keys_dropped_8", "unsigned_8", "wrap_512",
         "g1024", "overflow_64", "count_all_only", "uint64_keys",
         "beyond_f32_range"]


@functools.lru_cache(maxsize=None)
def _jax_result(name, backend):
    keys, aggs, vals, key_valid, kw, _ = _case(name)
    res = j_agg.hash_aggregate(
        _j(keys), aggs, {k: (_j(a), _j(v)) for k, (a, v) in vals.items()},
        key_valid=_j(key_valid), backend=backend, **kw)
    return {k: np.asarray(v) for k, v in res.items()}


def _port_result(name, backend):
    keys, aggs, vals, key_valid, kw, _ = _case(name)
    res = t_agg.hash_aggregate(
        _t(keys), aggs, {k: (_t(a), _t(v)) for k, (a, v) in vals.items()},
        key_valid=_t(key_valid), backend=backend, **kw)
    return {k: np.asarray(v) for k, v in res.items()}


def _groups(res):
    gc = int(res["group_count"])
    null = res["key_is_null"][:gc]
    return {(None if null[i] else int(res["keys"][i])):
            {k: v[i] for k, v in res.items() if k.startswith("agg:")}
            for i in range(gc)}


def _compare(got, want, vs_pallas):
    assert bool(got["overflow"]) == bool(want["overflow"])
    if bool(want["overflow"]):
        return
    assert int(got["group_count"]) == int(want["group_count"])
    for k in want:
        if k.startswith("agg:"):
            assert got[k].dtype == want[k].dtype, k
            assert got[k].shape == want[k].shape, k
    g, w = _groups(got), _groups(want)
    assert g.keys() == w.keys()
    for key, aggs in w.items():
        for k, want_v in aggs.items():
            got_v = g[key][k]
            kind = k.rsplit(":", 1)[1]
            if want_v.dtype.kind != "f":
                assert got_v == want_v, (key, k)
            elif kind in ("sum", "mean"):
                rtol = 1e-6 if vs_pallas else (
                    1e-5 if want_v.dtype == np.float32 or kind == "mean"
                    and got_v.dtype == np.float32 else 1e-12)
                np.testing.assert_allclose(got_v, want_v, rtol=rtol,
                                           err_msg=f"{key} {k}")
            elif vs_pallas and want_v.dtype == np.float64:
                np.testing.assert_allclose(got_v, want_v, rtol=1e-13,
                                           err_msg=f"{key} {k}")
            else:
                assert got_v.tobytes() == want_v.tobytes(), (key, k)


def _identities_in_tail(res):
    """Slots after the groups hold the empty-group identities."""
    gc = int(res["group_count"])
    if bool(res["overflow"]):
        return
    for k, v in res.items():
        if not k.startswith("agg:"):
            continue
        tail, kind = v[gc:], k.rsplit(":", 1)[1]
        if kind == "mean":
            assert np.isnan(tail).all(), k
        elif kind in ("sum", "count", "count_all"):
            assert (tail == 0).all(), k
        elif v.dtype.kind == "f":
            assert (tail == (np.inf if kind == "min" else -np.inf)).all(), k
        else:
            info = np.iinfo(v.dtype)
            assert (tail == (info.max if kind == "min" else info.min)).all()


@pytest.mark.parametrize("backend", ["auto", "xla", "pallas_interpret"])
@pytest.mark.parametrize("name", CASES)
def test_hash_aggregate_vs_jax_xla(name, backend):
    reset_launches()
    got = _port_result(name, backend)
    assert LAUNCHES["aggregate"] == 0       # CPU tensors: the plain version
    _compare(got, _jax_result(name, "xla"), vs_pallas=False)
    _identities_in_tail(got)
    assert not bool(got["overflow"]) or name == "overflow_64"


@pytest.mark.parametrize("name", [c for c in CASES if _case(c)[5]])
def test_hash_aggregate_vs_jax_pallas_interpret(name):
    got = _port_result(name, "pallas_interpret")
    want = _jax_result(name, "pallas_interpret")
    if name == "beyond_f32_range":
        # JAX's TPU-only f32-plane guard flags these f64 values; the port
        # is exact on them (held against JAX xla above) and does not
        assert bool(want["overflow"]) and not bool(got["overflow"])
        return
    _compare(got, want, vs_pallas=True)


def test_hash_aggregate_high_cardinality():
    """The generic path past the kernel's 1024 groups (group_ids under
    contention, segment_reduce's scatter tier), as the reference's
    test_aggregate_high_cardinality_4m checks it (which runs under jax.jit),
    at 2^18 rows and 20,003 keys, exact against numpy."""
    rng = np.random.default_rng(11)
    N, K = 1 << 18, 20_003
    keys = rng.integers(0, K, N)
    vals = rng.integers(-1000, 1000, N)
    res = t_agg.hash_aggregate(_t(keys), [("v", "sum"), ("v", "count")],
                               {"v": (_t(vals), None)}, max_groups=1 << 15)
    g = int(res["group_count"])
    assert not bool(res["overflow"]) and g == np.unique(keys).size
    got_keys = np.asarray(res["keys"])[:g]
    order = np.argsort(got_keys)
    present = np.unique(keys)
    np.testing.assert_array_equal(got_keys[order], present)
    np.testing.assert_array_equal(np.asarray(res["agg:v:count"])[:g][order],
                                  np.bincount(keys, minlength=K)[present])
    sums = np.zeros(K, np.int64)
    np.add.at(sums, keys, vals)
    np.testing.assert_array_equal(np.asarray(res["agg:v:sum"])[:g][order],
                                  sums[present])


# ---------------------------------------------------------------------------
# NaN and ±0.0 in min/max: the pyarrow oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["auto", "xla", "pallas_interpret"])
@pytest.mark.parametrize("dt", [np.float64, np.float32])
def test_nan_and_signed_zero_follow_pyarrow(dt, backend):
    nan, inf = np.nan, np.inf
    groups = {1: [nan, 1.0, 2.0], 2: [nan, nan], 3: [-0.0], 4: [0.0],
              5: [-0.0, -0.0], 6: [inf, nan], 7: [-inf, nan], 8: [0.0, -0.0],
              9: [-0.0, 0.0, 3.0]}
    keys = np.array([k for k, v in groups.items() for _ in v])
    vals = np.array([x for v in groups.values() for x in v], dt)
    t = pa.table({"k": keys, "v": vals})
    oracle = {r["k"]: (r["v_min"], r["v_max"]) for r in t.group_by("k")
              .aggregate([("v", "min"), ("v", "max")]).to_pylist()}
    res = t_agg.hash_aggregate(_t(keys), [("v", "min"), ("v", "max")],
                               {"v": (_t(vals), None)}, max_groups=16,
                               backend=backend)
    got = _groups({k: np.asarray(v) for k, v in res.items()})
    for k, (mn, mx) in oracle.items():
        gmn, gmx = got[k]["agg:v:min"], got[k]["agg:v:max"]
        assert gmn.dtype == gmx.dtype == dt
        for g, w in ((gmn, mn), (gmx, mx)):
            assert (np.isnan(g) and np.isnan(w)) or g == w, (k, g, w)
        if len({np.signbit(x) for x in groups[k] if x == 0}) == 1 or \
                k in (1, 6, 7):
            assert np.signbit(gmn) == np.signbit(mn), k
            assert np.signbit(gmx) == np.signbit(mx), k
    # mixed zeros: pyarrow keeps whichever comes first in row order; the
    # port orders -0.0 below +0.0
    assert np.signbit(got[8]["agg:v:min"]) and \
        not np.signbit(got[8]["agg:v:max"])


# ---------------------------------------------------------------------------
# K5's wrapper and the slice as a whole
# ---------------------------------------------------------------------------

def test_k5_wrapper_takes_plain_only_for_cpu():
    keys = torch.arange(10)
    cols = [k5.ValueColumn(torch.arange(10.0, dtype=torch.float64),
                           k5.FLOAT64)]
    with pytest.raises(ValueError, match="CUDA tensors"):
        k5.aggregate_cuda(keys, None, cols, 8)
    with pytest.raises(ValueError, match="no aggregate for device"):
        k5.aggregate(keys.to("meta"), None, [], 8)
    with pytest.raises(ValueError, match="float64"):
        k5.aggregate(keys, None, [k5.ValueColumn(torch.arange(10),
                                                 k5.FLOAT64)], 8)
    res = k5.aggregate(keys % 3, None, cols, 8)
    assert res.keys[:3].tolist() == [0, 1, 2] and int(res.count) == 3
    assert res.count_all[:3].tolist() == [4, 3, 3]
    assert res.acc[0, k5.ROW_SUM, :3].view(torch.float64).tolist() == \
        [18.0, 12.0, 15.0]


def test_k5_capacity_and_launch_groups():
    assert [k5.capacity_for(g) for g in (1, 8, 9, 64, 1000, 1024, 5000)] \
        == [8, 8, 16, 64, 1000, 1024, 1024]
    # more than MAX_VALUES columns: the plain version takes any number
    rng = np.random.default_rng(8)
    n = 5000
    keys = torch.from_numpy(rng.integers(0, 9, n))
    cols = [k5.ValueColumn(torch.from_numpy(rng.integers(-9, 9, n)),
                           k5.INT64) for _ in range(k5.MAX_VALUES + 2)]
    res = k5.aggregate(keys, None, cols, 16)
    for v, c in enumerate(cols):
        want = torch.zeros(9, dtype=torch.int64).index_add_(0, keys, c.data)
        assert torch.equal(res.acc[v, k5.ROW_SUM, :9], want)


@pytest.mark.parametrize("values", ["float", "int"])
def test_configs1_slice_vs_jax(values):
    """BASELINE configs[1]'s query (bench.py:79-93) at 100,003 rows through
    the port's kernel path (K5's plain version) and its generic path,
    against JAX's xla and pallas_interpret backends and pyarrow."""
    rng = np.random.default_rng(10)
    n = 100_003
    keys = rng.integers(0, 64, n) * 7 + 3
    vals = rng.random(n) if values == "float" else \
        rng.integers(-1000, 1000, n)
    aggs = [("v", "sum"), ("v", "count"), ("v", "min"), ("v", "max")]
    ref = {b: {k: np.asarray(v) for k, v in j_agg.hash_aggregate(
        _j(keys), aggs, {"v": (_j(vals), None)}, max_groups=64,
        backend=b).items()} for b in ("xla", "pallas_interpret")}
    oracle = {r["k"]: r for r in pa.table({"k": keys, "v": vals}).group_by(
        "k").aggregate([("v", "sum"), ("v", "count"), ("v", "min"),
                        ("v", "max")]).to_pylist()}
    for backend in ("pallas_interpret", "xla"):
        got = {k: np.asarray(v) for k, v in t_agg.hash_aggregate(
            _t(keys), aggs, {"v": (_t(vals), None)}, max_groups=64,
            backend=backend).items()}
        _compare(got, ref["xla"], vs_pallas=False)
        _compare(got, ref["pallas_interpret"], vs_pallas=True)
        groups = _groups(got)
        assert groups.keys() == oracle.keys()
        for k, r in oracle.items():
            assert groups[k]["agg:v:count"] == r["v_count"]
            assert groups[k]["agg:v:min"] == r["v_min"]
            assert groups[k]["agg:v:max"] == r["v_max"]
            np.testing.assert_allclose(groups[k]["agg:v:sum"], r["v_sum"],
                                       rtol=1e-12)
