"""The port's sort slice against gandiva_tpu on the CPU: the block sort
(kernel K4's plain version) against the reference's Pallas leaf, the
merge round (K3's plain version) against the reference's Pallas merge
round, ``merge_sort`` against ``merge_sort_u32``, and
``sort_permutation`` / ``sort_columns`` against ``gandiva_tpu.ops.sort``,
on the same inputs made with numpy from a seed.

The reference's Pallas kernels run as its own tests run them on the CPU,
in interpret mode, at a 1024-row tile (``w_log2=10``), which the port takes
through ``merge_sort``'s argument. The reference's 32-bit limbs are made from
the port's 64-bit words (hi, lo, bias-flipped to int32) and back.
``gandiva_tpu.ops.sort`` runs its CPU ``lax.sort`` path.

Everything is compared bit for bit, apart from two reference faults
(ROADMAP §3 item 4): where a float key holds NaN the reference places it
by its norm, above +inf, and Arrow between the nulls and the values, so
those cases are held against ``pyarrow.compute.sort_indices`` instead; and
the reference's sorted float keys are its canonical +0.0 and NaN, where
the port's keep each row's bits as Arrow's ``take`` does.
"""
import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import pytest
import torch

import jax.numpy as jnp

from gandiva_tpu.ops import sort as j_sort
from gandiva_tpu.ops.kernels import merge_path as j_mp
from gandiva_tpu.ops.kernels import sort_bitonic as j_sb
from gandiva_tpu_torch.ops import sort as t_sort
from gandiva_tpu_torch.ops.kernels import merge_path as t_mp
from gandiva_tpu_torch.ops.kernels import sort_bitonic as t_sb

W_LOG2 = 10
BIAS = np.uint32(0x8000_0000)
DTYPES = [np.bool_, np.int8, np.int16, np.int32, np.int64, np.uint8,
          np.uint16, np.uint32, np.uint64, np.float32, np.float64]


def _words(n, k, kind, rng):
    """uint64 [k, n]: uniform 64-bit words, heavy ties (values in [0, 3)),
    or an ascending or descending first word."""
    if kind == "ties":
        return rng.integers(0, 3, (k, n)).astype(np.uint64)
    w = rng.integers(0, 2**64 - 1, (k, n), dtype=np.uint64, endpoint=True)
    if kind == "sorted":
        w[0] = np.arange(n, dtype=np.uint64)
    elif kind == "reversed":
        w[0] = np.arange(n, 0, -1, dtype=np.uint64)
    return w


def _t(words_u64):
    return torch.from_numpy(np.ascontiguousarray(words_u64).view(np.int64))


def _u(t):
    return t.numpy().view(np.uint64)


def _u32_limbs(words_u64):
    """Per word its hi and lo uint32 limbs, most significant first."""
    return [part.astype(np.uint32) for w in words_u64
            for part in (w >> np.uint64(32), w & np.uint64(0xFFFF_FFFF))]


def _from_u32(limbs, n):
    """uint64 [k, n] from (hi, lo) uint32 limbs."""
    u = [np.asarray(v)[:n].astype(np.uint64) for v in limbs]
    return np.stack([(hi << np.uint64(32)) | lo
                     for hi, lo in zip(u[0::2], u[1::2])])


def _limbs(words_u64):
    """The operands of the reference's kernels K4 and K3: the uint32 limbs
    bias-flipped to int32."""
    return [jnp.asarray((x ^ BIAS).view(np.int32))
            for x in _u32_limbs(words_u64)]


def _from_limbs(limbs, n):
    """uint64 [k, n] from bias-flipped (hi, lo) int32 limbs."""
    return _from_u32([np.asarray(v)[:n].view(np.uint32) ^ BIAS
                      for v in limbs], n)


def _lexsort(words_u64):
    n = words_u64.shape[1]
    return np.lexsort((np.arange(n),) + tuple(words_u64[::-1]))


# ---------------------------------------------------------------------------
# K4: block_sort_plain against the reference's Pallas leaf
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,k,kind", [(2048, 2, "random"), (3072, 1, "ties")])
def test_block_sort_plain_vs_pallas_leaf(n, k, kind):
    words = _words(n, k, kind, np.random.default_rng(n))
    vals = _limbs(words) + [jnp.arange(n, dtype=jnp.int32)]
    want = j_sb._run_block_stages(vals, j_sb._stage_pairs_leaf(W_LOG2),
                                  W_LOG2, True, num_cmp=len(vals),
                                  local_dirs=True)
    idx, got = t_sb.block_sort_plain(_t(words), W_LOG2)
    assert idx.dtype == torch.int32
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want[-1]))
    np.testing.assert_array_equal(_u(got), _from_limbs(want[:-1], n))


def test_block_sort_plain_ragged_tile_and_tiny():
    """The ragged last tile keeps its rows (padding sorts behind them, even
    behind all-ones words), n < W, and n = 0."""
    rng = np.random.default_rng(5)
    for n in (0, 1, 700, 2 * 1024 + 301):
        words = _words(n, 2, "ties", rng)
        words[:, ::7] = np.uint64(2**64 - 1)
        idx, got = t_sb.block_sort_plain(_t(words), W_LOG2)
        for start in range(0, n, 1024):
            seg = slice(start, min(start + 1024, n))
            want = _lexsort(words[:, seg]) + start
            np.testing.assert_array_equal(idx.numpy()[seg], want)
            np.testing.assert_array_equal(_u(got)[:, seg], words[:, want])


def test_tile_halves_with_many_words():
    assert t_sb.tile_log2(1) == t_sb.DEFAULT_W_LOG2 == 13
    assert t_sb.tile_log2(2) == 13           # 8192 · 8 + 12 · 8705 B fit 227 KB
    assert t_sb.tile_log2(3) == 12
    assert t_sb.tile_log2(13) == 11          # 2048 · 96 + 12 · 2177 B fit
    assert t_sb.tile_log2(14) == 10
    assert t_sb.tile_log2(30) == 9
    assert t_sb.tile_log2(3, 10) == 10
    assert t_sb.tile_log2(1, 16) == t_sb.MAX_W_LOG2 == 14
    # K3's tile: MERGE_T_LOG2 outputs, at most the run, halved until it fits
    assert t_mp.merge_tile_log2(1, 13) == t_mp.MERGE_T_LOG2 == 12
    assert t_mp.merge_tile_log2(1, 8) == 8
    assert t_mp.merge_tile_log2(13, 11) == 11
    assert t_sb.tile_log2(56) == 9           # 512 · 440 + 12 · 545 B fit
    assert t_mp.merge_tile_log2(56, 9) == 8  # K3 holds 16 B a row more
    with pytest.raises(ValueError):
        t_sb.tile_log2(10_000)


# ---------------------------------------------------------------------------
# K3: merge_round_plain against the reference's Pallas merge round
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["random", "ties"])
def test_merge_round_plain_vs_pallas_rounds(kind):
    """n = 3000 at W = 1024: three runs, so round 0 merges one pair and
    copies the last run, round 1 merges a full run with a short one."""
    n, k = 3000, 2
    W = 1 << W_LOG2
    words = _words(n, k, kind, np.random.default_rng(11))
    idx, cur = t_sb.block_sort_plain(_t(words), W_LOG2)
    # the reference's state: limbs + index, padded as merge_sort_u32 pads
    nw = -(-n // W) * W
    total = nw + 2 * W
    pad = np.full(total - n, 2**31 - 1, np.int32)
    vals = [jnp.concatenate([v, pad])
            for v in _limbs(_u(cur)) + [jnp.asarray(idx.numpy())]]
    num_cmp = 2 * k + 1
    for rnd in range(t_mp.num_rounds(n, W_LOG2)):
        meta = j_mp._round_meta(vals, num_cmp, nw, W_LOG2, rnd)
        vals = j_mp._merge_round(vals, meta, num_cmp, W_LOG2, True)
        cur, idx = t_mp.merge_round_plain(cur, idx, W << rnd)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(vals[-1])[:n])
        np.testing.assert_array_equal(_u(cur), _from_limbs(vals[:-1], n))
    assert rnd == 1
    np.testing.assert_array_equal(idx.numpy(), _lexsort(words))


def test_merge_round_writes_into_out_and_refuses_aliasing():
    words = _t(_words(300, 1, "random", np.random.default_rng(2)))
    idx, cur = t_sb.block_sort_plain(words, 6)
    out = (torch.empty_like(cur), torch.empty_like(idx))
    got = t_mp.merge_round(cur, idx, 64, out=out)
    assert got[0] is out[0] and got[1] is out[1]
    want = t_mp.merge_round_plain(cur, idx, 64)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    with pytest.raises(ValueError, match="over its input"):
        t_mp.merge_round(cur, idx, 64, out=(cur, out[1]))
    with pytest.raises(ValueError, match="power of two"):
        t_mp.merge_round(cur, idx, 48)


# ---------------------------------------------------------------------------
# merge_sort against merge_sort_u32
# ---------------------------------------------------------------------------

def _vs_merge_sort_u32(words):
    n = words.shape[1]
    perm, sorted_limbs, _ = j_mp.merge_sort_u32(
        [jnp.asarray(x) for x in _u32_limbs(words)], w_log2=W_LOG2,
        interpret=True)
    got_perm, got = t_mp.merge_sort(list(_t(words)), w_log2=W_LOG2)
    assert got_perm.dtype == torch.int32 and got.shape == words.shape
    np.testing.assert_array_equal(got_perm.numpy(), np.asarray(perm))
    np.testing.assert_array_equal(_u(got), _from_u32(sorted_limbs, n))
    np.testing.assert_array_equal(got_perm.numpy(), _lexsort(words))


@pytest.mark.parametrize("n", [100, 1024, 3000, 5000, 16385])
def test_merge_sort_vs_merge_sort_u32(n):
    _vs_merge_sort_u32(_words(n, 1, "random", np.random.default_rng(n)))


@pytest.mark.parametrize("kind,k", [("ties", 2), ("sorted", 1),
                                    ("reversed", 1)])
def test_merge_sort_vs_merge_sort_u32_order(kind, k):
    _vs_merge_sort_u32(_words(3000, k, kind, np.random.default_rng(3)))


def test_merge_sort_takes_word_lists_and_empty_input():
    rng = np.random.default_rng(4)
    words = _words(2500, 3, "ties", rng)
    perm, got = t_mp.merge_sort([_t(w) for w in words], w_log2=W_LOG2)
    np.testing.assert_array_equal(perm.numpy(), _lexsort(words))
    perm, got = t_mp.merge_sort([torch.empty(0, dtype=torch.int64)])
    assert perm.shape == (0,) and perm.dtype == torch.int32
    assert got.shape == (1, 0)
    assert [t_mp.num_rounds(n, 11) for n in (0, 1, 2048, 2049, 100_000_000)
            ] == [0, 0, 0, 1, 16]


# One round at the largest tile, with a short B run; every tile of the sweep
# against the reference at its own 1024-row tile
_SWEEP_N = (1 << 14) + 2003


@pytest.fixture(scope="module", params=["random", "ties", "multi-word"])
def swept(request):
    """One input of ``_SWEEP_N`` rows and the reference's merge_sort_u32
    result on it: uniform words, heavy ties, or two words whose first is
    heavily tied."""
    rng = np.random.default_rng(_SWEEP_N + len(request.param))
    if request.param == "multi-word":
        words = _words(_SWEEP_N, 2, "random", rng)
        words[0] = rng.integers(0, 3, _SWEEP_N).astype(np.uint64)
    else:
        words = _words(_SWEEP_N, 1, request.param, rng)
    perm, sorted_limbs, _ = j_mp.merge_sort_u32(
        [jnp.asarray(x) for x in _u32_limbs(words)], w_log2=W_LOG2,
        interpret=True)
    return words, np.asarray(perm), _from_u32(sorted_limbs, _SWEEP_N)


@pytest.mark.parametrize("w_log2", [6, 10, 13, 14])
def test_merge_sort_tile_does_not_change_the_sort(swept, w_log2):
    """A stable sort has one result: the port's merge_sort at every tile
    of the card's sweep (and the smallest) equals the reference's."""
    words, perm, sorted_words = swept
    got_perm, got = t_mp.merge_sort(list(_t(words)), w_log2=w_log2)
    np.testing.assert_array_equal(got_perm.numpy(), perm)
    np.testing.assert_array_equal(_u(got), sorted_words)


@pytest.mark.parametrize("kind,k,run_log2", [
    ("random", 1, 6), ("ties", 1, 7), ("ties", 2, 6), ("random", 2, 8),
    ("sorted", 1, 6)])
def test_merge_splits_plain_vs_searchsorted(kind, k, run_log2):
    """K3's partition pass, plain: at each tile start, the number of A rows
    among the pair's outputs before it, against numpy's searchsorted form
    of the merge path (A[i] lands at i + #(B < A[i]); A wins ties). The
    rows are ranked first, so one integer orders like their words."""
    n = 5000
    run = 1 << run_log2
    words = _words(n, k, kind, np.random.default_rng(n + k + run_log2))
    _, cur = t_sb.block_sort_plain(_t(words), run_log2)
    got = t_mp.merge_splits_plain(cur, run).numpy()
    rank = np.unique(_u(cur).T, axis=0, return_inverse=True)[1].ravel()
    tile = 1 << t_mp.merge_tile_log2(k, run_log2)
    want = []
    for start in range(0, n, tile):
        pair = start // (2 * run) * (2 * run)
        a = rank[pair:min(pair + run, n)]
        b = rank[pair + run:min(pair + 2 * run, n)]
        lands = np.arange(len(a)) + np.searchsorted(b, a, side="left")
        want.append(int((lands < start - pair).sum()))
    assert got.dtype == np.int32 and len(got) == -(-n // tile)
    np.testing.assert_array_equal(got, want)
    assert (got > 0).any()


# ---------------------------------------------------------------------------
# sort_permutation / sort_columns against gandiva_tpu.ops.sort
# ---------------------------------------------------------------------------

def _torch(x):
    if x is None:
        return None
    return torch.from_numpy(np.ascontiguousarray(x))


def _column(dt, n, rng):
    """n values of ``dt`` over its whole range, with its edge values (for
    floats ±0.0 and ±inf, no NaN), and ties."""
    dt = np.dtype(dt)
    if dt == np.bool_:
        return rng.random(n) < 0.5
    if dt.kind == "f":
        x = (rng.integers(-40, 40, n) / 4).astype(dt)
        x[rng.random(n) < 0.05] = np.inf
        x[rng.random(n) < 0.05] = -np.inf
        x[rng.random(n) < 0.1] = -0.0
        x[:4] = [np.finfo(dt).max, -np.finfo(dt).max, np.finfo(dt).tiny, 0]
        return x
    info = np.iinfo(dt)
    x = rng.integers(info.min, info.max, n, dtype=dt, endpoint=True)
    x[rng.random(n) < 0.3] = x[0]
    x[:4] = [info.min, info.max, 0, 1]
    return x


def _bits(a):
    a = np.asarray(a)
    return a.view({2: np.int16, 4: np.int32, 8: np.int64}[a.itemsize]) \
        if a.dtype.kind == "f" else a


def _run_both(keys, payload=(), length=None):
    """(port, reference) results of sort_columns on the same columns; keys
    are (values, validity, ascending, nulls_first) numpy tuples."""
    port = t_sort.sort_columns(
        [t_sort.SortKey(_torch(v), _torch(m), a, f) for v, m, a, f in keys],
        [_torch(p) for p in payload], length=length)
    ref = j_sort.sort_columns(
        [j_sort.SortKey(jnp.asarray(v), None if m is None else jnp.asarray(m),
                        a, f) for v, m, a, f in keys],
        [jnp.asarray(p) for p in payload], length=length)
    return ([np.asarray(port[0])] + [x.numpy() for x in port[1] + port[2]],
            [np.asarray(ref[0])] + [np.asarray(x) for x in ref[1] + ref[2]])


def _hold(keys, payload=(), length=None):
    """Perm, sorted keys and payloads bit-exact with the reference; float
    keys equal to it as values (the reference's are canonical) and
    bit-exact with values[perm]."""
    port, ref = _run_both(keys, payload, length)
    perm = port[0]
    assert perm.dtype == np.int32
    np.testing.assert_array_equal(perm, ref[0])
    for (v, _, _, _), got, want in zip(keys, port[1:], ref[1:]):
        assert got.dtype == want.dtype
        if got.dtype.kind == "f":
            np.testing.assert_array_equal(got, want)          # -0.0 == 0.0
            np.testing.assert_array_equal(_bits(got), _bits(v[perm]))
        else:
            np.testing.assert_array_equal(got, want)
    for got, want in zip(port[1 + len(keys):], ref[1 + len(keys):]):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(_bits(got), _bits(want))
    return perm


def _payloads(n, rng):
    return [rng.integers(-2**31, 2**31, n).astype(np.int32),
            rng.standard_normal(n),
            rng.integers(0, 2**64 - 1, n, dtype=np.uint64, endpoint=True),
            rng.random(n) < 0.5,
            rng.integers(0, 2**16, n).astype(np.uint16)]


@pytest.mark.parametrize("ascending", [True, False])
@pytest.mark.parametrize("dt", DTYPES, ids=lambda d: np.dtype(d).name)
def test_sort_columns_every_dtype_vs_reference(dt, ascending):
    rng = np.random.default_rng(DTYPES.index(dt))
    n = 3000
    x = _column(dt, n, rng)
    if np.dtype(dt) == np.uint32:
        assert (x >= 2**31).any()
    if np.dtype(dt).kind == "f":
        assert np.signbit(x[x == 0]).any() and np.isinf(x).any()
    _hold([(x, None, ascending, True)], _payloads(n, rng))


@pytest.mark.parametrize("later_key", [False, True])
@pytest.mark.parametrize("nulls_first", [True, False])
@pytest.mark.parametrize("ascending", [True, False])
def test_sort_nulls_vs_reference(ascending, nulls_first, later_key):
    """Nulls first and last, on the first key or on a later one; null rows'
    values are arbitrary and must not order them."""
    rng = np.random.default_rng(7)
    n = 4000
    a = rng.integers(0, 5, n).astype(np.int32)
    b = rng.integers(-100, 100, n)
    valid = rng.random(n) >= 0.15
    if later_key:
        keys = [(a, None, True, nulls_first),
                (b, valid, ascending, nulls_first)]
    else:
        keys = [(a, valid, ascending, nulls_first),
                (b, None, True, nulls_first)]
    perm = _hold(keys, _payloads(n, rng)[:2])
    if not later_key:    # the nulls sit at the end nulls_first names
        nulls = ~valid[perm]
        count = int((~valid).sum())
        where = slice(0, count) if nulls_first else slice(n - count, n)
        assert nulls[where].all()


@pytest.mark.parametrize("nullable", [False, True])
def test_sort_length_padding_vs_reference(nullable):
    rng = np.random.default_rng(8)
    n, length = 2500, 2411
    k = rng.integers(-50, 50, n)
    valid = rng.random(n) >= 0.2 if nullable else None
    perm = _hold([(k, valid, False, False)], _payloads(n, rng)[:1],
                 length=length)
    assert set(perm[length:].tolist()) == set(range(length, n))
    perm = t_sort.sort_permutation(
        [t_sort.SortKey(_torch(k), _torch(valid))], length=torch.tensor(7))
    assert sorted(perm[:7].tolist()) == list(range(7))


def test_sort_multi_key_mixed_dtypes_vs_reference():
    rng = np.random.default_rng(9)
    n = 3000
    keys = [(rng.random(n) < 0.5, None, False, True),
            ((rng.integers(-3, 3, n) / 2).astype(np.float32), None, False,
             True),
            (rng.integers(0, 4, n).astype(np.uint16), rng.random(n) >= 0.1,
             True, False),
            (rng.integers(-2**62, 2**62, n), None, True, True)]
    _hold(keys, _payloads(n, rng))


def test_sort_many_keys_halve_the_tile_vs_reference():
    """13 nullable keys are 26 words: the tile halves from 8192 to 1024."""
    rng = np.random.default_rng(10)
    n = 2100
    keys = [(rng.integers(0, 2, n).astype(np.int8), rng.random(n) >= 0.3,
             j % 2 == 0, j % 3 == 0) for j in range(13)]
    words, _, _ = t_sort._build_operands(
        [t_sort.SortKey(_torch(v), _torch(m), a, f) for v, m, a, f in keys],
        None)
    assert len(words) == 26 and t_sb.tile_log2(26) == 10
    _hold(keys, _payloads(n, rng)[:1])


def test_sort_tiny_and_empty():
    rng = np.random.default_rng(12)
    for n in (1, 2, 5, 63):
        _hold([(rng.integers(-3, 3, n), rng.random(n) >= 0.3, False, True)],
              _payloads(n, rng)[:2])
    perm, (sk,), (sp,) = t_sort.sort_columns(
        [t_sort.SortKey(torch.empty(0, dtype=torch.float64))],
        [torch.empty(0, dtype=torch.int32)])
    assert perm.shape == sk.shape == sp.shape == (0,)
    assert perm.dtype == torch.int32 and sk.dtype == torch.float64


def test_build_operands_rank_words():
    """One word for a non-null integer key; a rank word before the norm for
    a float key, a nullable key and the padded first key; narrower norms
    widened by zero extension."""
    n = 6
    i64 = torch.arange(n)
    i32 = torch.tensor([-1, 0, 1, -2**31, 2**31 - 1, 5], dtype=torch.int32)
    f = torch.tensor([1.0, float("nan"), -0.0, float("inf"), 2.0, -1.0])
    valid = torch.tensor([True, False, True, True, False, True])
    SortKey, build = t_sort.SortKey, t_sort._build_operands
    assert len(build([SortKey(i64)], None)[0]) == 1
    assert len(build([SortKey(i64)], 4)[0]) == 2
    words, key_word, dts = build([SortKey(i32), SortKey(f, valid, False)],
                                 None)
    assert key_word == [0, 2] and dts == [torch.int32, torch.int32]
    assert words[0].tolist() == ((i32.long() ^ -2**31) & 0xFFFF_FFFF).tolist()
    assert (words[0] >= 0).all() and (words[0] < 2**32).all()
    # nulls first: null 0, NaN 1, value 2; NaN and null norms zeroed
    assert words[1].tolist() == [2, 0, 2, 2, 0, 2]
    assert words[2][1] == 0 and words[2][4] == 0
    words, _, _ = build([SortKey(f, valid, True, False)], 3)
    assert words[0].tolist() == [0, 2, 0, 4, 6, 4]


# ---------------------------------------------------------------------------
# NaN keys: against pyarrow, where the reference disagrees
# ---------------------------------------------------------------------------

def _float_keys(dt, n, rng):
    x = (rng.integers(-8, 8, n) / 2).astype(dt)
    x[rng.random(n) < 0.08] = np.nan
    x[rng.random(n) < 0.05] = -np.nan
    x[rng.random(n) < 0.08] = -0.0
    x[rng.random(n) < 0.04] = np.inf
    x[rng.random(n) < 0.04] = -np.inf
    return x


def _arrow_perm(columns, orders, nulls_first):
    table = pa.table({f"k{i}": a for i, a in enumerate(columns)})
    return np.asarray(pc.sort_indices(
        table, sort_keys=[(f"k{i}", "ascending" if asc else "descending")
                          for i, asc in enumerate(orders)],
        null_placement="at_start" if nulls_first else "at_end"))


@pytest.mark.parametrize("dt", [np.float32, np.float64])
@pytest.mark.parametrize("nulls_first", [True, False])
@pytest.mark.parametrize("ascending", [True, False])
def test_nan_keys_vs_arrow(ascending, nulls_first, dt):
    rng = np.random.default_rng(13)
    n = 2000
    x = _float_keys(dt, n, rng)
    valid = rng.random(n) >= 0.1
    pay = rng.integers(0, 10**6, n)
    perm, (sk,), (sp,) = t_sort.sort_columns(
        [t_sort.SortKey(_torch(x), _torch(valid), ascending, nulls_first)],
        [_torch(pay)])
    want = _arrow_perm([pa.array(x, mask=~valid)], [ascending], nulls_first)
    np.testing.assert_array_equal(perm.numpy(), want)
    np.testing.assert_array_equal(_bits(sk.numpy()), _bits(x[want]))
    np.testing.assert_array_equal(sp.numpy(), pay[want])


@pytest.mark.parametrize("nulls_first", [True, False])
def test_nan_on_a_later_key_vs_arrow(nulls_first):
    """(a ascending, b descending), b a float64 key with NaN and nulls."""
    rng = np.random.default_rng(14)
    n = 3000
    a = rng.integers(0, 4, n)
    b = _float_keys(np.float64, n, rng)
    valid = rng.random(n) >= 0.1
    perm, (sa, sb), _ = t_sort.sort_columns(
        [t_sort.SortKey(_torch(a), None, True, nulls_first),
         t_sort.SortKey(_torch(b), _torch(valid), False, nulls_first)])
    want = _arrow_perm([pa.array(a), pa.array(b, mask=~valid)],
                       [True, False], nulls_first)
    np.testing.assert_array_equal(perm.numpy(), want)
    np.testing.assert_array_equal(sa.numpy(), a[want])
    np.testing.assert_array_equal(_bits(sb.numpy()), _bits(b[want]))


def test_arrow_placement_examples():
    x = np.array([1.0, np.nan, -0.0, 0.0, np.inf, np.nan, -1.0])
    valid = np.array([True, True, True, True, True, False, True])
    for asc, first, want in ((True, True, [5, 1, 6, 2, 3, 0, 4]),
                             (False, False, [4, 0, 2, 3, 6, 1, 5])):
        perm = t_sort.sort_permutation(
            [t_sort.SortKey(_torch(x), _torch(valid), asc, first)])
        assert perm.tolist() == want
        assert want == _arrow_perm([pa.array(x, mask=~valid)], [asc],
                                   first).tolist()
    b = np.array([np.nan, np.nan, 2.0, -0.0])
    perm = t_sort.sort_permutation(
        [t_sort.SortKey(_torch(np.zeros(4, np.int64))),
         t_sort.SortKey(_torch(b), _torch(np.array([1, 0, 1, 1], bool)),
                        False, True)])
    assert perm.tolist() == [1, 0, 2, 3]


def test_reference_places_nan_against_arrow():
    """The reference fault of ROADMAP §3 item 4: ascending with nulls
    first, the reference sorts NaN after +inf and Arrow (and the port)
    between the nulls and the values; the reference's sorted key also
    comes back as its canonical +0.0 where the row held -0.0."""
    x = np.array([1.0, np.nan, -0.0, 0.0, np.inf, np.nan, -1.0])
    valid = np.array([True, True, True, True, True, False, True])
    arrow = _arrow_perm([pa.array(x, mask=~valid)], [True], True)
    ref_perm, (ref_key,), _ = j_sort.sort_columns(
        [j_sort.SortKey(jnp.asarray(x), jnp.asarray(valid), True, True)])
    port = t_sort.sort_permutation(
        [t_sort.SortKey(_torch(x), _torch(valid), True, True)])
    assert np.asarray(ref_perm).tolist() == [5, 6, 2, 3, 0, 4, 1]
    assert arrow.tolist() == port.tolist() == [5, 1, 6, 2, 3, 0, 4]
    ref_key = np.asarray(j_sort.sort_columns(
        [j_sort.SortKey(jnp.asarray(x[[2, 0]]))])[1][0])
    assert not np.signbit(ref_key[0])
    port_key = t_sort.sort_columns([t_sort.SortKey(_torch(x[[2, 0]]))])[1][0]
    assert np.signbit(port_key.numpy()[0])
