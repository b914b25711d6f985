"""Kernels K1 (stream compaction, csrc/compaction.cu), K2 (single-pass
look-back compaction, csrc/compaction_fragnet.cu), K5 (one-pass GROUP BY,
csrc/aggregate.cu), K4 (block sort, csrc/sort_bitonic.cu) and K3
(merge-path round, csrc/merge_path.cu) against their plain torch versions
on the card, and the join on the card against the same join on the CPU.
Marked ``gpu``; each test decides in its body whether a card is present
and skips with a reason where there is none. Needs no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py
"""
import pytest
import torch

from gandiva_tpu_torch.ops.kernels import LAUNCHES, reset_launches
from gandiva_tpu_torch.ops.kernels.compaction import (compact_columns,
                                                      compact_columns_plain)

pytestmark = pytest.mark.gpu


def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the CPU tests cover the plain version")
    return torch.device("cuda")


def _bits(t):
    if t.dtype.is_floating_point:
        return t.view({4: torch.int32, 8: torch.int64}[t.element_size()])
    return t


@pytest.mark.parametrize("n,density", [
    (1, 1.0), (4096, 0.0), (4096, 1.0), (8192, 0.43), (3 * 4096 + 17, 0.97),
    (1_000_037, 0.5), (1 << 22, 0.02)])
def test_k1_matches_plain(n, density):
    dev = _card()
    g = torch.Generator(device=dev)
    g.manual_seed(n)
    mask = torch.rand(n, generator=g, device=dev) < density
    cols = [torch.randint(-2**62, 2**62, (n,), generator=g, device=dev),
            torch.rand(n, generator=g, dtype=torch.float64, device=dev),
            torch.rand(n, generator=g, device=dev),
            torch.randint(-2**15, 2**15, (n,), generator=g, device=dev
                          ).to(torch.int16),
            torch.rand(n, generator=g, device=dev) < 0.5]
    reset_launches()
    idx, packed, count = compact_columns(mask, cols)
    torch.cuda.synchronize()
    assert LAUNCHES["compact"] == 1
    widx, wpacked, wcount = compact_columns_plain(mask, cols)
    c = int(wcount)
    assert int(count) == c
    assert torch.equal(idx[:c], widx[:c])
    for got, want in zip(packed, wpacked):
        assert torch.equal(_bits(got[:c]), _bits(want[:c]))


@pytest.mark.parametrize("capacity", [0, 1000, 500_000, 1_000_037,
                                      1_200_000])
def test_k1_capacity_matches_cpu(capacity):
    """compact_mask and compact_values with a capacity take K1 on the card
    and give the CPU's capacity-sized buffers (survivors past capacity
    dropped, the tail zero) and the full count."""
    dev = _card()
    from gandiva_tpu_torch.ops.compaction import compact_mask, compact_values

    n = 1_000_037
    g = torch.Generator(device=dev)
    g.manual_seed(capacity + 1)
    mask = torch.rand(n, generator=g, device=dev) < 0.5
    vals = torch.rand(n, generator=g, dtype=torch.float64, device=dev)
    reset_launches()
    idx, count = compact_mask(mask, capacity)
    packed, vcount = compact_values(mask, vals, capacity)
    torch.cuda.synchronize()
    assert LAUNCHES["compact"] == 2
    cidx, ccount = compact_mask(mask.cpu(), capacity)
    cpacked, _ = compact_values(mask.cpu(), vals.cpu(), capacity)
    assert int(count) == int(vcount) == int(ccount) == int(mask.sum())
    assert idx.shape == packed.shape == (capacity,)
    assert torch.equal(idx.cpu(), cidx)
    assert torch.equal(_bits(packed.cpu()), _bits(cpacked))


def _payloads(n, g, dev):
    return [torch.randint(-2**62, 2**62, (n,), generator=g, device=dev),
            torch.rand(n, generator=g, dtype=torch.float64, device=dev),
            torch.rand(n, generator=g, device=dev),
            torch.randint(-2**15, 2**15, (n,), generator=g, device=dev
                          ).to(torch.int16),
            torch.rand(n, generator=g, device=dev) < 0.5]


def _same_compaction(got, want):
    (idx, packed, count), (widx, wpacked, wcount) = got, want
    c = int(wcount)
    assert int(count) == c
    assert torch.equal(idx[:c], widx[:c])
    assert len(packed) == len(wpacked)
    for a, b in zip(packed, wpacked):
        assert a.dtype == b.dtype
        assert torch.equal(_bits(a[:c]), _bits(b[:c]))


@pytest.mark.parametrize("n,density", [
    (0, 0.5), (1, 1.0), (1000, 0.5), (4096, 0.0), (4096, 1.0), (8192, 0.43),
    (3 * 4096 + 17, 0.97), (1_000_037, 0.5), (1 << 22, 0.02),
    (33 * 4096 * 32, 0.5)])
def test_k2_matches_plain_and_k1(n, density):
    """K2 (one launch) against its plain version and against K1, bit for
    bit on [:count]; the last case has more tiles than one look-back
    window holds many times over."""
    dev = _card()
    from gandiva_tpu_torch.ops.kernels.compaction_fragnet import (
        compact_fragnet_columns, compact_fragnet_plain)

    g = torch.Generator(device=dev)
    g.manual_seed(n + 3)
    mask = torch.rand(n, generator=g, device=dev) < density
    cols = _payloads(n, g, dev)
    reset_launches()
    got = compact_fragnet_columns(mask, cols)
    torch.cuda.synchronize()
    assert LAUNCHES["compact_fragnet"] == (1 if n else 0)
    _same_compaction(got, compact_fragnet_plain(mask, cols))
    _same_compaction(got, compact_columns(mask, cols))


def test_k2_many_payloads_and_back_to_back_calls():
    """Ten payloads (the single pass, then one scatter-only launch over the
    recorded tile offsets), and 20 calls in a row on new masks, each held
    against the plain version: no state survives from one call to the
    next."""
    dev = _card()
    from gandiva_tpu_torch.ops.kernels.compaction_fragnet import (
        compact_fragnet_columns, compact_fragnet_plain)

    g = torch.Generator(device=dev)
    g.manual_seed(12)
    n = 1_000_037
    base = _payloads(n, g, dev)
    cols = base + [c.flip(0) for c in base]
    mask = torch.rand(n, generator=g, device=dev) < 0.43
    reset_launches()
    got = compact_fragnet_columns(mask, cols)
    torch.cuda.synchronize()
    assert LAUNCHES["compact_fragnet"] == 2
    _same_compaction(got, compact_fragnet_plain(mask, cols))
    for k in range(20):
        mask = torch.rand(n, generator=g, device=dev) < (k + 1) / 21
        got = compact_fragnet_columns(mask, base[:2])
        _same_compaction(got, compact_fragnet_plain(mask, base[:2]))


@pytest.mark.parametrize("n,density", [
    (1 << 20, 0.0), (1 << 20, 1.0), (4096 * 5 - 1, 0.3), (1, 0.0)])
def test_k2_edge_shapes_match_plain_and_k1(n, density):
    """Density 0 and 1 over many tiles, n one short of a multiple of the
    tile, n = 1 with nothing kept."""
    dev = _card()
    from gandiva_tpu_torch.ops.kernels.compaction_fragnet import (
        compact_fragnet_columns, compact_fragnet_plain)

    g = torch.Generator(device=dev)
    g.manual_seed(n + 31)
    mask = torch.rand(n, generator=g, device=dev) < density
    cols = _payloads(n, g, dev)
    got = compact_fragnet_columns(mask, cols)
    torch.cuda.synchronize()
    _same_compaction(got, compact_fragnet_plain(mask, cols))
    _same_compaction(got, compact_columns(mask, cols))


@pytest.mark.parametrize("offset", [1, 3, 8])
def test_k2_unaligned_views_match_plain_and_k1(offset):
    """A mask and payloads that start ``offset`` elements into their
    buffers, so neither the mask nor the 1- and 2-byte payloads are 16-B
    aligned (the kernel's byte-load and element paths); 8 is 16-B aligned
    for the 2-byte column only."""
    dev = _card()
    from gandiva_tpu_torch.ops.kernels.compaction_fragnet import (
        compact_fragnet_columns, compact_fragnet_plain)

    g = torch.Generator(device=dev)
    g.manual_seed(offset)
    n = 1_000_037
    mask = (torch.rand(n + offset, generator=g, device=dev) < 0.4)[offset:]
    cols = [c[offset:] for c in _payloads(n + offset, g, dev)]
    assert mask.data_ptr() % 16 != 0 or offset == 8
    got = compact_fragnet_columns(mask, cols)
    torch.cuda.synchronize()
    _same_compaction(got, compact_fragnet_plain(mask, cols))
    _same_compaction(got, compact_columns(mask, cols))


def test_k2_many_payload_groups_match_plain():
    """Eight payloads of mixed widths: the kernel stages them in several
    groups of its shared-memory budget, the first while it looks back."""
    dev = _card()
    from gandiva_tpu_torch.ops.kernels import compaction_fragnet as k2

    g = torch.Generator(device=dev)
    g.manual_seed(16)
    n = 3 * 4096 * 32 + 5
    base = _payloads(n, g, dev)
    cols = base + [c.flip(0) for c in base[:3]]
    mask = torch.rand(n, generator=g, device=dev) < 0.6
    got = k2.compact_fragnet_columns(mask, cols)
    torch.cuda.synchronize()
    _same_compaction(got, k2.compact_fragnet_plain(mask, cols))


def test_flagship_plan_launches_k1():
    dev = _card()
    from gandiva_tpu_torch.entrypoints import flagship_step

    fn, args = flagship_step(dev)
    reset_launches()
    idx, count, value, valid = fn(*args)
    torch.cuda.synchronize()
    assert LAUNCHES["compact"] == 1
    a, a_valid, b, _ = args
    keep = (a > 500) & a_valid
    c = int(keep.sum())
    assert int(count) == c
    assert torch.equal(idx[:c].long(), torch.nonzero(keep).flatten())
    assert torch.equal(value[:c], (b * 2.0 + a.double())[keep])


@pytest.mark.parametrize("density", [0.0, 0.02, 0.474, 0.97, 1.0])
def test_k1_densities_match_plain(density):
    """Densities on both sides of the scatter's bulk-load threshold, so
    dense tiles (loaded whole) and sparse ones (survivor by survivor) both
    run, with a ragged last tile."""
    dev = _card()
    g = torch.Generator(device=dev)
    g.manual_seed(int(density * 1000) + 7)
    n = 37 * 4096 + 123
    mask = torch.rand(n, generator=g, device=dev) < density
    cols = _payloads(n, g, dev)
    reset_launches()
    got = compact_columns(mask, cols)
    torch.cuda.synchronize()
    assert LAUNCHES["compact"] == 1
    _same_compaction(got, compact_columns_plain(mask, cols))


@pytest.mark.parametrize("n", [4 * 4096 - 1, 4 * 4096, 4 * 4096 + 1,
                               1_000_037])
def test_k1_indices_only_matches_plain(n):
    """No payload (Filter.evaluate): one scatter launch writes the row
    indices and the count."""
    dev = _card()
    g = torch.Generator(device=dev)
    g.manual_seed(n)
    mask = torch.rand(n, generator=g, device=dev) < 0.474
    reset_launches()
    got = compact_columns(mask, [])
    torch.cuda.synchronize()
    assert LAUNCHES["compact"] == 1
    _same_compaction(got, compact_columns_plain(mask, []))


@pytest.mark.parametrize("offset", [1, 3, 8])
def test_k1_unaligned_views_match_plain_and_k2(offset):
    """A mask and payloads that start ``offset`` elements into their
    buffers: the count pass counts byte by byte and the scatter takes the
    mask and the 1- and 2-byte columns element by element (8 leaves the
    2-byte column 16-B aligned)."""
    dev = _card()
    from gandiva_tpu_torch.ops.kernels.compaction_fragnet import (
        compact_fragnet_columns)

    g = torch.Generator(device=dev)
    g.manual_seed(offset + 40)
    n = 1_000_037
    mask = (torch.rand(n + offset, generator=g, device=dev) < 0.4)[offset:]
    cols = [c[offset:] for c in _payloads(n + offset, g, dev)]
    got = compact_columns(mask, cols)
    torch.cuda.synchronize()
    _same_compaction(got, compact_columns_plain(mask, cols))
    _same_compaction(got, compact_fragnet_columns(mask, cols))


def test_k1_back_to_back_calls():
    """20 calls in a row on new masks, none checked until all have run."""
    dev = _card()
    g = torch.Generator(device=dev)
    g.manual_seed(20)
    n = 1_000_037
    cols = _payloads(n, g, dev)[:2]
    masks = [torch.rand(n, generator=g, device=dev) < (k + 1) / 21
             for k in range(20)]
    runs = [compact_columns(m, cols) for m in masks]
    torch.cuda.synchronize()
    for m, got in zip(masks, runs):
        _same_compaction(got, compact_columns_plain(m, cols))


@pytest.mark.parametrize("n,density", [(4096, 1.0), (1_000_037, 0.43)])
def test_k1_many_payloads_matches_plain(n, density):
    """Ten payloads: two scatter launches over the same tile offsets."""
    dev = _card()
    g = torch.Generator(device=dev)
    g.manual_seed(n + 1)
    mask = torch.rand(n, generator=g, device=dev) < density
    base = [torch.randint(-2**62, 2**62, (n,), generator=g, device=dev),
            torch.rand(n, generator=g, dtype=torch.float64, device=dev),
            torch.rand(n, generator=g, device=dev),
            torch.randint(-2**31, 2**31, (n,), generator=g, device=dev
                          ).to(torch.int32),
            torch.rand(n, generator=g, device=dev) < 0.5]
    cols = base + [c.flip(0) for c in base]
    reset_launches()
    idx, packed, count = compact_columns(mask, cols)
    torch.cuda.synchronize()
    assert LAUNCHES["compact"] == 2
    widx, wpacked, wcount = compact_columns_plain(mask, cols)
    c = int(wcount)
    assert int(count) == c
    assert torch.equal(idx[:c], widx[:c])
    assert len(packed) == len(cols)
    for got, want in zip(packed, wpacked):
        assert torch.equal(_bits(got[:c]), _bits(want[:c]))


def test_multi_projection_filter_project_matches_cpu():
    """Six projections of mixed widths (twelve payloads) through K1 on the
    card, bit for bit against the same plan on the CPU."""
    dev = _card()
    import numpy as np
    import pyarrow as pa

    import gandiva_tpu_torch as gt

    B, dt = gt.TreeExprBuilder, gt.dtypes
    rng = np.random.default_rng(4)
    n = 100_003
    batch = pa.RecordBatch.from_arrays(
        [pa.array(rng.integers(-10**6, 10**6, n), mask=rng.random(n) < 0.1),
         pa.array(rng.integers(-100, 100, n).astype(np.int32)),
         pa.array(rng.normal(0, 50, n), mask=rng.random(n) < 0.1),
         pa.array(rng.random(n) < 0.5, mask=rng.random(n) < 0.1)],
        names=["a", "i", "f", "x"])
    schema = dt.Schema.from_arrow(batch.schema)
    F = {f.name: B.make_field(f) for f in schema}

    def fn(name, ret, *args):
        return B.make_function(name, list(args), ret)

    cond = B.make_condition(fn("greater_than", dt.bool_, F["i"],
                               B.make_int32_literal(-20)))
    roots = [
        fn("add", dt.float64, fn("multiply", dt.float64, F["f"],
                                 B.make_double_literal(2.0)),
           fn("castFLOAT8", dt.float64, F["a"])),
        fn("add", dt.int32, F["i"], B.make_int32_literal(7)),
        fn("multiply", dt.int64, F["a"], B.make_int64_literal(3)),
        fn("less_than", dt.bool_, F["f"], B.make_double_literal(0.5)),
        fn("castFLOAT4", dt.float32, F["a"]),
        B.make_and([F["x"], fn("isnull", dt.bool_, F["f"])]),
    ]
    exprs = [B.make_expression(r, dt.Field(f"r{k}", r.dtype))
             for k, r in enumerate(roots)]
    outs = {}
    for d in (dev, torch.device("cpu")):
        reset_launches()
        fp = gt.make_filter_project(schema, cond, exprs, use_cache=False,
                                    device=d)
        sel, cols = fp.evaluate(batch)
        if d.type == "cuda":
            assert LAUNCHES["compact"] == 2
        outs[d.type] = (sel.to_numpy(), cols)
    (gi, gcols), (ci, ccols) = outs["cuda"], outs["cpu"]
    np.testing.assert_array_equal(gi, ci)
    assert 0 < len(gi) < n
    for got, want in zip(gcols, ccols):
        assert got.equals(want)


# ---------------------------------------------------------------------------
# K5 (one-pass GROUP BY, csrc/aggregate.cu) against its plain torch version
# ---------------------------------------------------------------------------

def _bits64(n, g, dev):
    """Uniform random 64-bit patterns as int64."""
    hi = torch.randint(0, 2**32, (n,), generator=g, device=dev)
    return (hi << 32) | torch.randint(0, 2**32, (n,), generator=g, device=dev)


def _k5_columns(n, g, dev, with_nulls):
    """The smoke's ragged matrix at a small size: int8, int32, uint32,
    uint64, f32 and f64 values (six columns: two K5 launches), each with
    10% nulls when ``with_nulls``."""
    from gandiva_tpu_torch.ops.hash_aggregate import _kernel_column

    raw = [torch.randint(-128, 128, (n,), generator=g, device=dev
                         ).to(torch.int8),
           torch.randint(-2**31, 2**31, (n,), generator=g, device=dev
                         ).to(torch.int32),
           torch.randint(0, 2**32, (n,), generator=g, device=dev
                         ).to(torch.int32).view(torch.uint32),
           _bits64(n, g, dev).view(torch.uint64),
           (torch.rand(n, generator=g, device=dev) * 200 - 100),
           torch.randn(n, generator=g, dtype=torch.float64, device=dev)]
    cols = []
    for k, a in enumerate(raw):
        valid = (torch.rand(n, generator=g, device=dev) >= 0.1) \
            if with_nulls else None
        cols.append(_kernel_column(a, valid, want_sum=k != 2,
                                   want_minmax=k != 3))
    return cols


def _hold_k5(got, want, kinds, rtol=1e-9):
    """Bit-exact apart from float sums (atomics add in a varying order);
    only the flag is compared where the query overflows."""
    from gandiva_tpu_torch.ops.kernels.aggregate import FLOAT64, ROW_SUM

    assert bool(got.overflow) == bool(want.overflow)
    if bool(want.overflow):
        return
    assert int(got.count) == int(want.count)
    assert torch.equal(got.keys, want.keys)
    assert torch.equal(got.count_all, want.count_all)
    assert got.acc.shape == want.acc.shape
    for v in range(want.acc.shape[0]):
        for r in range(4):
            g, w = got.acc[v, r], want.acc[v, r]
            if r == ROW_SUM and kinds[v] == FLOAT64:
                torch.testing.assert_close(g.view(torch.float64),
                                           w.view(torch.float64), rtol=rtol,
                                           atol=0, equal_nan=True)
            else:
                assert torch.equal(g, w), (v, r)


@pytest.mark.parametrize("n,groups,max_groups,nulls", [
    (1, 1, 8, False), (1000, 7, 16, True), (100_003, 64, 64, False),
    (1_000_037, 64, 64, True), (300_007, 1000, 1024, True),
    (200_003, 1500, 1024, False), (50_000, 300, 256, True)])
def test_k5_matches_plain(n, groups, max_groups, nulls):
    dev = _card()
    from gandiva_tpu_torch.ops.kernels.aggregate import (aggregate,
                                                         aggregate_plain)

    g = torch.Generator(device=dev)
    g.manual_seed(n + groups)
    keys = torch.randint(0, groups, (n,), generator=g, device=dev) * 7 - 3
    code = None
    if nulls:
        u = torch.rand(n, generator=g, device=dev)
        code = torch.where(u < 0.1, 2, torch.where(u < 0.15, 0, 1)
                           ).to(torch.uint8)
    cols = _k5_columns(n, g, dev, nulls)
    reset_launches()
    got = aggregate(keys, code, cols, max_groups)
    torch.cuda.synchronize()
    assert LAUNCHES["aggregate"] == 2
    want = aggregate_plain(keys, code, cols, max_groups)
    _hold_k5(got, want, [c.kind for c in cols])
    if groups > max_groups:
        assert bool(got.overflow)


def test_k5_extreme_keys_and_count_only():
    """Keys int64::min, int64::max and 0 (no sentinel key value), and a
    query with no value columns (one launch)."""
    dev = _card()
    from gandiva_tpu_torch.ops.kernels.aggregate import (aggregate,
                                                         aggregate_plain)

    g = torch.Generator(device=dev)
    g.manual_seed(5)
    pool = torch.tensor([-2**63, 2**63 - 1, 0, -1, 1], device=dev)
    n = 77_777
    keys = pool[torch.randint(0, 5, (n,), generator=g, device=dev)]
    for cols in ([], _k5_columns(n, g, dev, True)[:4]):
        reset_launches()
        got = aggregate(keys, None, cols, 8)
        torch.cuda.synchronize()
        assert LAUNCHES["aggregate"] == 1
        want = aggregate_plain(keys, None, cols, 8)
        _hold_k5(got, want, [c.kind for c in cols])
        assert int(got.count) == 5
        assert got.keys[:5].tolist() == sorted(pool.tolist())


def test_hash_aggregate_on_card_matches_cpu():
    """configs[1]'s query through hash_aggregate("auto") on the card (K5)
    against the same query on the CPU (K5's plain version)."""
    dev = _card()
    import numpy as np

    from gandiva_tpu_torch.ops import hash_aggregate

    rng = np.random.default_rng(1)
    n = 100_003
    keys = rng.integers(0, 64, n) * 7 + 3
    for vals in (rng.random(n), rng.integers(-1000, 1000, n)):
        out = {}
        for d in (dev, torch.device("cpu")):
            reset_launches()
            out[d.type] = hash_aggregate(
                torch.from_numpy(keys).to(d),
                [("v", "sum"), ("v", "count"), ("v", "min"), ("v", "max")],
                {"v": (torch.from_numpy(vals).to(d), None)}, max_groups=64)
            if d.type == "cuda":
                assert LAUNCHES["aggregate"] == 1
        for k, want in out["cpu"].items():
            got = out["cuda"][k].cpu()
            if got.dtype.is_floating_point and k.endswith(":sum"):
                torch.testing.assert_close(got, want, rtol=1e-9, atol=0)
            else:
                assert torch.equal(got, want), k


def _k5_case(name, g, dev):
    """(keys, code, columns, max_groups) of the named edge shape."""
    from gandiva_tpu_torch.ops.hash_aggregate import _kernel_column

    n = 200_003
    if name == "one group":
        keys = torch.full((n,), -42, dtype=torch.int64, device=dev)
        return keys, None, _k5_columns(n, g, dev, True)[:4], 8
    if name == "1024 groups x 4 columns":
        keys = torch.randperm(n, generator=g, device=dev) % 1024 * 13 - 99
        return keys, None, _k5_columns(n, g, dev, True)[2:], 1024
    if name == "1100 keys at gcap 1024":
        keys = torch.randint(0, 1100, (n,), generator=g, device=dev)
        return keys, None, _k5_columns(n, g, dev, False)[:2], 1024
    if name == "uint64 extremes":
        pool = torch.tensor([0, 1, -1, -2**63, 2**63 - 1], device=dev)
        vals = pool[torch.randint(0, 5, (n,), generator=g, device=dev)]
        keys = torch.randint(0, 3, (n,), generator=g, device=dev)
        return keys, None, [_kernel_column(vals.view(torch.uint64), None,
                                           True, True)], 8
    if name == "NaN and signed zeros":
        pool = torch.tensor([float("nan"), -0.0, 0.0, float("inf"),
                             float("-inf"), 1.5], dtype=torch.float64,
                            device=dev)
        vals = pool[torch.randint(0, 6, (n,), generator=g, device=dev)]
        valid = torch.rand(n, generator=g, device=dev) >= 0.3
        keys = torch.randint(0, 40, (n,), generator=g, device=dev)
        # group 0 holds only NaN, group 1 only ±0.0
        vals = torch.where(keys == 0, float("nan"), vals)
        vals = torch.where(keys == 1, -(torch.rand(n, generator=g,
                                                   device=dev) < 0.5)
                           .double() * 0.0, vals)
        return keys, None, [_kernel_column(vals, valid, True, True)], 64
    assert name == "gcap 8, codes 0/1/2"
    keys = torch.randint(-3, 3, (n,), generator=g, device=dev)
    code = torch.randint(0, 3, (n,), generator=g, device=dev
                         ).to(torch.uint8)
    return keys, code, _k5_columns(n, g, dev, True)[3:5], 8


@pytest.mark.parametrize("name", [
    "one group", "1024 groups x 4 columns", "1100 keys at gcap 1024",
    "uint64 extremes", "NaN and signed zeros", "gcap 8, codes 0/1/2"])
def test_k5_edge_shapes_match_plain(name):
    """Each edge shape on the variant the kernel picks for it."""
    dev = _card()
    from gandiva_tpu_torch.ops.kernels.aggregate import (aggregate_cuda,
                                                         aggregate_plain)

    g = torch.Generator(device=dev)
    g.manual_seed(len(name))
    keys, code, cols, max_groups = _k5_case(name, g, dev)
    got = aggregate_cuda(keys, code, cols, max_groups)
    torch.cuda.synchronize()
    want = aggregate_plain(keys, code, cols, max_groups)
    _hold_k5(got, want, [c.kind for c in cols])
    if name == "1100 keys at gcap 1024":
        assert bool(got.overflow)


@pytest.mark.parametrize("keys_,ncols,max_groups,nulls,private", [
    (64, 2, 64, False, True),      # configs[1]'s keys: 16 private copies
    (2, 2, 64, False, True),       # every warp-step: pointer jumping
    (1024, 1, 1024, False, False),  # a few shared copies
    (2, 1, 1024, False, False),    # shared copies, pointer jumping
    (1024, 4, 1024, False, False),  # one shared copy
    (1024, 4, 1024, True, False)])
def test_k5_variants_match_plain(keys_, ncols, max_groups, nulls, private):
    """Both accumulator variants, on the shapes that select them, at
    2,000,003 rows: ``keys_`` distinct keys (few keys put many peers in a
    warp-step, so the rounds and the pointer jumping both run), ``ncols``
    value columns of int64 and float64, 10% null keys where ``nulls``."""
    dev = _card()
    from gandiva_tpu_torch.ops.hash_aggregate import _kernel_column
    from gandiva_tpu_torch.ops.kernels.aggregate import (
        accumulator_copies, aggregate_cuda, aggregate_plain, capacity_for)

    assert accumulator_copies(capacity_for(max_groups), ncols)[1] == private
    g = torch.Generator(device=dev)
    g.manual_seed(keys_ + ncols)
    n = 2_000_003
    keys = torch.randint(0, keys_, (n,), generator=g, device=dev) * 7 + 3
    code = None
    if nulls:
        code = torch.where(torch.rand(n, generator=g, device=dev) < 0.1, 2,
                           1).to(torch.uint8)
    cols = [_kernel_column(
        torch.rand(n, generator=g, dtype=torch.float64, device=dev) if v % 2
        else torch.randint(-1000, 1000, (n,), generator=g, device=dev),
        None, True, True) for v in range(ncols)]
    got = aggregate_cuda(keys, code, cols, max_groups)
    torch.cuda.synchronize()
    _hold_k5(got, aggregate_plain(keys, code, cols, max_groups),
             [c.kind for c in cols])


def _sorted_groups(res):
    """A hash_aggregate result's groups on the host, ordered by (null key,
    key), so results in different group orders compare."""
    cnt = int(res["group_count"])
    keys = res["keys"][:cnt].cpu()
    null = res["key_is_null"][:cnt].cpu()
    order = sorted(range(cnt), key=lambda i: (bool(null[i]), int(keys[i])))
    idx = torch.tensor(order, dtype=torch.int64)
    return {k: (v[:cnt].cpu()[idx] if v.dim() else v.cpu())
            for k, v in res.items()}


@pytest.mark.parametrize("case", ["4096 groups, 3000 keys", "float64 keys",
                                  "backend xla, 64 groups"])
def test_generic_group_by_on_card_matches_cpu(case):
    """hash_aggregate's generic path (group_ids' claim rounds or
    distinct_small, and segment_reduce's scatters; K5 does not run) on the
    card against the same call on the CPU, groups compared in key order."""
    dev = _card()
    import numpy as np

    from gandiva_tpu_torch.ops import hash_aggregate

    rng = np.random.default_rng(7)
    n = 300_007
    max_groups, backend = 64, "auto"
    if case == "4096 groups, 3000 keys":
        keys = rng.integers(0, 3000, n) * 1_000_003 - 7
        max_groups = 4096
    elif case == "float64 keys":
        keys = rng.integers(-30, 30, n) / 4.0
        keys[rng.random(n) < 0.01] = np.nan
        keys[rng.random(n) < 0.01] = -0.0
    else:
        keys = rng.integers(0, 64, n) * 7 + 3
        backend = "xla"
    vals = rng.standard_normal(n)
    ivals = rng.integers(-2**40, 2**40, n)
    kv = rng.random(n) >= 0.05
    vv = rng.random(n) >= 0.1
    aggs = [("v", "sum"), ("v", "count"), ("v", "min"), ("v", "max"),
            ("v", "mean"), ("i", "sum"), ("i", "min"), ("i", "max"),
            ("i", "count_all")]
    out = {}
    for d in (dev, torch.device("cpu")):
        reset_launches()

        def t(a):
            return torch.from_numpy(a).to(d)

        out[d.type] = _sorted_groups(hash_aggregate(
            t(keys), aggs, {"v": (t(vals), t(vv)), "i": (t(ivals), None)},
            key_valid=t(kv), max_groups=max_groups, backend=backend))
        if d.type == "cuda":
            torch.cuda.synchronize()
            assert LAUNCHES["aggregate"] == 0
    got, want = out["cuda"], out["cpu"]
    assert int(want["group_count"]) > 60 and not bool(want["overflow"])
    for k, w in want.items():
        if k.endswith((":sum", ":mean")) and w.dtype.is_floating_point:
            torch.testing.assert_close(got[k], w, rtol=1e-9, atol=0,
                                       equal_nan=True)
        else:
            assert torch.equal(_bits(got[k]), _bits(w)), k


# ---------------------------------------------------------------------------
# K4 (block sort, csrc/sort_bitonic.cu) and K3 (merge-path round,
# csrc/merge_path.cu) against their plain torch versions
# ---------------------------------------------------------------------------

def _sort_words(n, k, kind, g, dev):
    """k comparator words of n rows: uniform 64-bit patterns, heavy ties
    (values in [0, 3)), all equal, or an ascending or descending first
    word."""
    if kind == "ties":
        return torch.randint(0, 3, (k, n), generator=g, device=dev)
    if kind == "equal":
        return torch.full((k, n), 7, dtype=torch.int64, device=dev)
    words = torch.stack([_bits64(n, g, dev) for _ in range(k)])
    if kind == "sorted":
        words[0] = torch.arange(n, device=dev)
    elif kind == "reversed":
        words[0] = torch.arange(n, 0, -1, device=dev)
    return words.contiguous()


_W = 1 << 13   # the default tile of one word


@pytest.mark.parametrize("n,k,kind,w_log2", [
    (0, 1, "random", None), (1, 1, "random", None), (1000, 1, "random", None),
    (2048, 1, "ties", None), (4096 + 17, 1, "sorted", None),
    (1_000_037, 1, "random", None), (1_000_037, 1, "ties", None),
    (300_007, 1, "reversed", None), (100_003, 2, "ties", None),
    (30_011, 4, "ties", None), (20_011, 30, "ties", None),
    (65_536, 3, "random", None),
    # n = W 2^r - 1, W 2^r and W 2^r + 1 at the default tile
    (4 * _W - 1, 1, "random", None), (4 * _W, 1, "random", None),
    (4 * _W + 1, 1, "random", None),
    # all keys equal: every split sits on A's ties
    (4 * _W + 3, 1, "equal", None), (3 * _W + 5, 2, "equal", None),
    # the last pair's B run short, round after round
    (5 * _W + 100, 1, "random", None), (9 * _W + 1, 2, "random", None),
    # two and three words, the tile halved for three, and for two words
    # when 2^14 rows are asked
    (4 * _W + 1, 2, "random", None), (3 * _W + 11, 3, "ties", None),
    (5 * _W + 3, 2, "random", 14),
    # each tile of the sweep
    (100_003, 1, "random", 11), (100_003, 1, "random", 12),
    (100_003, 1, "ties", 13), (100_003, 1, "random", 14),
    (3 * (1 << 14) + 7, 1, "ties", 14)])
def test_k4_k3_match_plain(n, k, kind, w_log2):
    """K4 once and every K3 round, each against its plain version on the
    same input, bit for bit, and each round's partition pass against its
    plain version; many words halve the tile. Random keys put segment
    starts on odd rows, so the asynchronous copies are not 16-B aligned."""
    dev = _card()
    from gandiva_tpu_torch.ops.kernels.merge_path import (
        merge_round, merge_round_plain, merge_sort, merge_splits_cuda,
        merge_splits_plain, num_rounds)
    from gandiva_tpu_torch.ops.kernels.sort_bitonic import (
        DEFAULT_W_LOG2, block_sort, block_sort_plain, tile_log2)

    g = torch.Generator(device=dev)
    g.manual_seed(n + k)
    words = _sort_words(n, k, kind, g, dev)
    asked = DEFAULT_W_LOG2 if w_log2 is None else w_log2
    w_log2 = tile_log2(k, asked)
    assert w_log2 <= asked - 2 or k != 30      # 30 words halve it twice
    reset_launches()
    idx, cur = block_sort(words, w_log2)
    torch.cuda.synchronize()
    assert LAUNCHES["sort_block"] == (1 if n else 0)
    widx, wcur = block_sort_plain(words, w_log2)
    assert torch.equal(idx, widx) and torch.equal(cur, wcur)
    rounds = num_rounds(n, w_log2)
    odd = False
    for r in range(rounds):
        run = 1 << (w_log2 + r)
        splits = merge_splits_cuda(cur, run)
        torch.cuda.synchronize()
        assert torch.equal(splits, merge_splits_plain(cur, run))
        odd = odd or bool((splits % 2 == 1).any())
        got = merge_round(cur, idx, run)
        torch.cuda.synchronize()
        want = merge_round_plain(cur, idx, run)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        cur, idx = got
    assert LAUNCHES["merge_path"] == rounds
    if kind == "random" and rounds:
        assert odd
    perm, sorted_words = merge_sort(list(words), w_log2)
    assert torch.equal(perm, idx) and torch.equal(sorted_words, cur)
    assert torch.equal(perm.long().sort().values, torch.arange(n, device=dev))


def test_sort_cuda_entries_refuse_cpu_tensors():
    from gandiva_tpu_torch.ops.kernels.merge_path import (merge_round_cuda,
                                                          merge_splits_cuda)
    from gandiva_tpu_torch.ops.kernels.sort_bitonic import block_sort_cuda

    words = torch.zeros((1, 8), dtype=torch.int64)
    with pytest.raises(ValueError, match="CUDA"):
        block_sort_cuda(words, 11)
    with pytest.raises(ValueError, match="CUDA"):
        merge_round_cuda(words, torch.zeros(8, dtype=torch.int32), 2048)
    with pytest.raises(ValueError, match="CUDA"):
        merge_splits_cuda(words, 2048)


def test_sort_columns_on_card_matches_cpu():
    """A nullable int64 key (nulls first), a descending float64 key with
    -0.0, NaN and ±inf, and two payloads: the card's sort_columns (K4 once,
    K3 every round) against the same call on the CPU."""
    dev = _card()
    import numpy as np

    from gandiva_tpu_torch.ops import SortKey, sort_columns
    from gandiva_tpu_torch.ops.kernels.merge_path import num_rounds
    from gandiva_tpu_torch.ops.kernels.sort_bitonic import tile_log2

    rng = np.random.default_rng(9)
    n = 200_003
    a = rng.integers(-50, 50, n)
    f = rng.integers(-4, 4, n) / 2.0
    f[rng.random(n) < 0.05] = np.nan
    f[rng.random(n) < 0.05] = -0.0
    f[rng.random(n) < 0.02] = np.inf
    f[rng.random(n) < 0.02] = -np.inf
    cols = {"a": a, "valid": rng.random(n) >= 0.1, "f": f,
            "p": rng.integers(0, 10**9, n), "q": rng.random(n) < 0.5}
    out = {}
    for d in (dev, torch.device("cpu")):
        t = {name: torch.from_numpy(v).to(d) for name, v in cols.items()}
        reset_launches()
        out[d.type] = sort_columns(
            [SortKey(t["a"], t["valid"]), SortKey(t["f"], ascending=False)],
            [t["p"], t["q"]])
        if d.type == "cuda":
            w_log2 = tile_log2(4)
            assert LAUNCHES["sort_block"] == 1
            assert LAUNCHES["merge_path"] == num_rounds(n, w_log2)
    (gp, gk, gv), (cp, ck, cv) = out["cuda"], out["cpu"]
    assert torch.equal(gp.cpu(), cp)
    for got, want in zip(gk + gv, ck + cv):
        assert torch.equal(_bits(got.cpu()), _bits(want))


# ---------------------------------------------------------------------------
# The join (slice E) on the card: K4 and K3 sort the build side, K2 compacts
# the probe's residues; the same join on the CPU takes their plain versions
# ---------------------------------------------------------------------------

def _join_both(fn, arrays):
    """``fn`` on CUDA copies of ``arrays`` and on CPU copies: (card result
    on the host, CPU result, the card run's launches)."""
    dev = _card()
    out = {}
    for d in (dev, torch.device("cpu")):
        reset_launches()
        res = fn(*[torch.from_numpy(a).to(d) if a is not None else None
                   for a in arrays])
        if d.type == "cuda":
            torch.cuda.synchronize()
            launched = dict(LAUNCHES)
        out[d.type] = res
    return out["cuda"], out["cpu"], launched


def _same_join(got, want):
    c = int(want.count)
    assert int(got.count) == c and bool(got.overflow) == bool(want.overflow)
    assert torch.equal(got.probe_idx[:c].cpu(), want.probe_idx[:c])
    assert torch.equal(got.build_idx[:c].cpu(), want.build_idx[:c])


@pytest.mark.parametrize("how", ["inner", "left", "right", "full", "semi",
                                 "anti"])
def test_join_on_card_matches_cpu(how):
    """The dense probe: 100,003 probe rows × 30,011 build rows with
    duplicates and 10% null keys on both sides."""
    import numpy as np

    from gandiva_tpu_torch.ops import join

    rng = np.random.default_rng(3)
    n, nb = 100_003, 30_011
    arrays = [rng.integers(0, 40_000, n), rng.integers(0, 50_000, nb),
              rng.random(n) >= 0.1, rng.random(nb) >= 0.1]
    got, want, launched = _join_both(
        lambda p, b, pv, bv: join(p, b, 400_000, how, probe_valid=pv,
                                  build_valid=bv), arrays)
    _same_join(got, want)
    assert launched["compact_fragnet"] >= 1
    assert launched["sort_block"] == 2 and launched["merge_path"] >= 2


def test_join_hot_path_on_card_matches_cpu():
    """The hot-key probe (≥ 2^22 rows): Zipf(1.3) probe keys, so the cold
    rows and their second tier go through K2."""
    import numpy as np

    from gandiva_tpu_torch.ops import join

    rng = np.random.default_rng(4)
    n, nb = (1 << 22) + 37, 200_003
    arrays = [(rng.zipf(1.3, n) % 100_000).astype(np.int64),
              rng.integers(0, 100_000, nb)]
    got, want, launched = _join_both(
        lambda p, b: join(p, b, 16 * n, "inner"), arrays)
    _same_join(got, want)
    assert launched["compact_fragnet"] == 2


@pytest.mark.parametrize("dups", [0, 5_000])
def test_hash_probe_unique_on_card_matches_cpu(dups):
    """Build keys whose home slots collide (200,003 keys in a table of
    4× their count claim the same slot in a round many times over), with
    and without duplicate keys: the claim rounds must settle every slot on
    one whole build row, so the card equals the CPU, flag included."""
    import numpy as np

    from gandiva_tpu_torch.ops.hash_join import _hash_probe_unique

    rng = np.random.default_rng(6)
    nb = 200_003
    build = rng.choice(1 << 40, nb, replace=False)
    build[rng.integers(0, nb, dups)] = build[rng.integers(0, nb, dups)]
    probe = np.concatenate([build, rng.integers(0, 1 << 40, 100_000)])
    arrays = [probe, build, rng.random(probe.size) >= 0.1,
              rng.random(nb) >= 0.05]
    got, want, _ = _join_both(_hash_probe_unique, arrays)
    assert bool(got[2]) == bool(want[2]) == (dups > 0)
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])


def test_join_multi_and_stream_on_card_match_cpu():
    import numpy as np

    from gandiva_tpu_torch.ops import join_multi, join_stream

    rng = np.random.default_rng(5)
    n, nb = 50_000, 5_000
    arrays = [rng.integers(0, 500, n), rng.integers(0, 4, n),
              rng.integers(0, 600, nb), rng.integers(0, 4, nb)]
    for how in ("inner", "full"):
        got, want, _ = _join_both(
            lambda p1, p2, b1, b2: join_multi([p1, p2], [b1, b2], 1 << 20,
                                              how), arrays)
        _same_join(got, want)
    chunks = rng.integers(0, 800, (3, n))
    got, want, launched = _join_both(
        lambda c, b: join_stream(b, 3, probe_stacked=c, capacity=8 * n)(),
        [chunks, arrays[2]])
    assert not bool(got[1]) and not bool(want[1])
    for i in range(3):
        _same_join(type(want[0])(*(f[i] for f in got[0])),
                   type(want[0])(*(f[i] for f in want[0])))
    assert launched["compact_fragnet"] >= 3


# The join build's run detection and placement (csrc/join_build.cu) against
# the plain torch chain on CPU copies of the same sorted keys: nb 0, 1 and a
# tile (4,096 rows) ± 1; unique keys, one run of all nb, mixed runs; n_valid
# below nb with a valid max-key run that the pinned invalid tail would
# lengthen; perm given or not (inner, right/full); the table factor's steps
# at 2^21 and 2^22 rows; n_valid as a device tensor or an int.
_BUILD_RANGES = [
    # nb, keys, n_valid, max-key run, perm, n_valid a tensor
    (0, "unique", 0, False, True, False),
    (1, "unique", 1, False, True, True),
    (1, "unique", 0, False, False, False),
    (4095, "unique", 4095, False, True, True),
    (4096, "one", 4096, False, True, False),
    (4096, "one", 4096, False, False, True),
    (4097, "mixed", 4097, False, True, True),
    (4097, "unique", 4097, False, False, False),
    (4096, "mixed", 4001, True, True, True),
    (4097, "unique", 3000, True, False, False),
    (100_003, "mixed", 99_000, True, True, True),
    (100_003, "mixed", 99_000, True, False, True),
    (100_003, "one", 100_003, False, True, False),
    (100_003, "unique", 50_000, False, True, False),
    (1 << 21, "mixed", (1 << 21) - 5, True, True, True),
    ((1 << 21) + 1, "unique", (1 << 21) + 1, False, True, True),
    (1 << 22, "mixed", 4_000_000, False, False, True),
    ((1 << 22) + 1, "mixed", (1 << 22) + 1, False, True, True),
]


def _sorted_build_keys(nb, kind, n_valid, max_run, rng):
    """Sorted 64-bit norms as int64 bits: the first ``n_valid`` valid, the
    rest pinned to the all-ones norm, as ``build_join_table`` pins them."""
    import numpy as np

    if kind == "unique":
        keys = np.cumsum(rng.integers(1, 1000, nb))
    elif kind == "one":
        keys = np.full(nb, 12_345)
    else:
        keys = np.cumsum(rng.integers(0, 3, nb))
    keys = keys.astype(np.int64)
    keys[max(n_valid, 0):] = -1
    if max_run:
        keys[max(n_valid - 3, 0):] = -1
    return keys


@pytest.mark.parametrize("case", _BUILD_RANGES,
                         ids=[f"{c[0]}-{c[1]}-{c[2]}-{'max' if c[3] else 'nomax'}"
                              f"-{'perm' if c[4] else 'noperm'}"
                              f"-{'tensor' if c[5] else 'int'}"
                              for c in _BUILD_RANGES])
def test_join_build_kernels_match_plain(case):
    import numpy as np

    from gandiva_tpu_torch.ops.hash_join import _build_ranges_table

    nb, kind, n_valid, max_run, with_perm, nv_tensor = case
    dev = _card()
    rng = np.random.default_rng(nb + n_valid)
    keys = torch.from_numpy(_sorted_build_keys(nb, kind, n_valid, max_run,
                                               rng))
    perm = torch.from_numpy(rng.permutation(nb).astype(np.int32)) \
        if with_perm else None
    out = {}
    for d in (dev, torch.device("cpu")):
        nv = torch.tensor(n_valid, dtype=torch.int32, device=d) \
            if nv_tensor else n_valid
        reset_launches()
        table, unique = _build_ranges_table(
            keys.to(d), nv, None if perm is None else perm.to(d))
        if d.type == "cuda":
            torch.cuda.synchronize()
            assert LAUNCHES["join_build"] == (2 if nb else 0)
        out[d.type] = (table.cpu(), bool(unique))
    assert out["cuda"][0].dtype == torch.int32
    assert torch.equal(out["cuda"][0], out["cpu"][0])
    assert out["cuda"][1] == out["cpu"][1]


def test_join_build_kernels_place_past_2_31_slots():
    """A table of more than 2^31 slots (T = 3 * 2^30 home slots, about 52 GB
    of the card): the kernels' 64-bit homes, positions and scan place every
    run where the plain chain does on the card, about a quarter of them
    past slot 2^31."""
    import numpy as np

    from gandiva_tpu_torch.ops.hash_join import _build_ranges_plain
    from gandiva_tpu_torch.ops.kernels.join_build import build_ranges_cuda

    dev = _card()
    rng = np.random.default_rng(31)
    nb, n_valid = 100_003, 99_000
    keys = torch.from_numpy(_sorted_build_keys(nb, "mixed", n_valid, True,
                                               rng)).to(dev)
    perm = torch.from_numpy(rng.permutation(nb).astype(np.int32)).to(dev)
    T = 3 << 30
    placed = []
    for route in (build_ranges_cuda, _build_ranges_plain):
        table, unique = route(keys, n_valid, perm, T)
        assert table.shape == (T + nb, 4)
        slots = table.any(1).nonzero().flatten()
        placed.append((slots, table.index_select(0, slots), bool(unique)))
        del table
        torch.cuda.empty_cache()
    (got_slots, got_rows, got_unique), (slots, rows, unique) = placed
    assert torch.equal(got_slots, slots)
    assert torch.equal(got_rows, rows)
    assert got_unique == unique
    assert int((slots >= 1 << 31).sum()) > 0


def test_join_build_kernels_join_and_probe_match_cpu():
    """build_join_table and probe_chunk on the card: the table, the flag and
    the JoinResult equal the CPU's, over duplicate and null build keys."""
    import numpy as np

    from gandiva_tpu_torch.ops import build_join_table, probe_chunk

    rng = np.random.default_rng(9)
    n, nb = 1_000_003, 300_007
    arrays = [rng.integers(0, 250_000, n), rng.integers(0, 200_000, nb),
              rng.random(nb) >= 0.05]

    def run(p, b, bv):
        jt = build_join_table(b, build_valid=bv)
        return jt, probe_chunk(jt, p, 4 * n)

    got, want, launched = _join_both(run, arrays)
    assert torch.equal(got[0].table.cpu(), want[0].table)
    assert bool(got[0].all_unique) == bool(want[0].all_unique)
    _same_join(got[1], want[1])
    assert launched["join_build"] == 2


# ---------------------------------------------------------------------------
# the decimal, date/time, interval and hash registry on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,types,ret", [
    ("hash64", ("int64", "int64"), "int64"),
    ("hash64AsDouble", ("int64",), "float64"),
    ("extractWeek", ("timestamp",), "int64"),
    ("months_between", ("timestamp", "timestamp"), "float64"),
    ("add", ("date32", "interval_day"), "date32"),
    ("multiply", ("decimal128(38,10)", "decimal128(28,6)"), None),
    ("multiply", ("decimal128(28,6)", "decimal128(9,2)"), None),
    ("divide", ("decimal128(18,4)", "decimal128(9,2)"), None),
    ("round", ("decimal128(38,10)",), None),
    ("castFLOAT8", ("decimal128(38,10)",), "float64"),
    ("castDECIMAL", ("float64",), "decimal128(18,4)"),
])
def test_registry_family_on_card_matches_cpu(name, types, ret):
    """One signature of each family of the date/time, interval, hash and
    decimal registry through make_projector on the card and on the CPU at
    4,096 rows, bit for bit (floats by their bits)."""
    dev = _card()
    import numpy as np

    import gandiva_tpu_torch as gt
    from chip_smoke import registry_column
    from gandiva_tpu_torch.registry.decimal_ops import ensure_registered

    B, dt = gt.TreeExprBuilder, gt.dtypes
    rng = np.random.default_rng(len(name) + len(types))
    # full-range integers: the only integer arguments here are hash64's
    cpu = gt.from_columns_numpy(
        {f"a{i}": (t, *registry_column(t, 4096, rng, amount=False))
         for i, t in enumerate(types)}, 4096, device="cpu")
    schema = dt.Schema([dt.Field(k, c.dtype) for k, c in cpu.columns.items()])
    args = [B.make_field(f) for f in schema]
    ensure_registered([a.dtype for a in args])
    rt = gt.batch.parse_dtype(ret) if ret else gt.global_registry() \
        .lookup_or_raise(name, [a.dtype for a in args]).signature.return_type
    node = B.make_function(name, args, rt)
    expr = B.make_expression(node, dt.Field("out", rt))
    card = gt.Batch({k: gt.Column(c.data.to(dev), c.validity.to(dev),
                                  c.dtype, extra=None if c.extra is None
                                  else c.extra.to(dev))
                     for k, c in cpu.columns.items()}, cpu.length)
    outs = [gt.make_projector(schema, [expr], use_cache=False, device=d)
            .evaluate_device(b).column("out") for d, b in
            ((dev, card), (torch.device("cpu"), cpu))]
    got, want = outs
    assert torch.equal(got.validity.cpu(), want.validity)
    assert torch.equal(_bits(got.data).cpu(), _bits(want.data))
    if want.extra is not None:
        assert torch.equal(got.extra.cpu(), want.extra)


def _same_output(got, want, c):
    """A card output column against the CPU's on [:c]: validity and data
    bits, the high limb, and a string's dictionary by value."""
    assert torch.equal(got.validity[:c].cpu(), want.validity[:c])
    assert torch.equal(_bits(got.data[:c]).cpu(), _bits(want.data[:c]))
    if want.extra is not None:
        assert torch.equal(got.extra[:c].cpu(), want.extra[:c])
    if want.dictionary is not None:
        assert got.dictionary.equals(want.dictionary)


@pytest.mark.parametrize("query", ["q1", "q6", "q7", "q12", "q19"])
def test_tpch_scan_on_card_matches_cpu(query):
    """TPC-H Q1's, Q6's, Q7's, Q12's and Q19's lineitem scans at 4,096 rows on
    the card and on the CPU: the same selection, decimal limbs and string
    codes under the same dictionaries, K1 launched (Q1's sixteen payloads
    take two scatter launches)."""
    dev = _card()
    from gandiva_tpu_torch import entrypoints as e

    make = {"q1": e.tpch_q1_scan, "q6": e.tpch_q6_scan,
            "q7": e.tpch_q7_scan, "q12": e.tpch_q12_scan,
            "q19": e.tpch_q19_scan}[query]
    cpu = e.lineitem(4096, seed=3, device="cpu")
    card = cpu.to(dev)
    reset_launches()
    gsel, gout = make(dev).evaluate_device(card)
    assert LAUNCHES["compact"] == (2 if query == "q1" else 1)
    csel, cout = make("cpu").evaluate_device(cpu)
    c = int(csel.count)
    assert int(gsel.count) == c > 0
    assert torch.equal(gsel.indices[:c].cpu(), csel.indices[:c])
    for name in cout.columns:
        _same_output(gout.column(name), cout.column(name), c)


@pytest.mark.parametrize("query", ["q9", "q16"])
def test_tpch_part_scan_on_card_matches_cpu(query):
    """Q9's and Q16's PART predicates over 20,000 rows brought in through
    from_arrow on the card and on the CPU: the same selection and
    outputs, K1 launched once."""
    dev = _card()
    from gandiva_tpu_torch import entrypoints as e

    make = e.tpch_q9_part_scan if query == "q9" else e.tpch_q16_part_scan
    arrow = e.part_arrow(20000, seed=9)
    reset_launches()
    gsel, gout = make(dev).evaluate_device(e.from_arrow(arrow, device=dev))
    assert LAUNCHES["compact"] == 1
    csel, cout = make("cpu").evaluate_device(e.from_arrow(arrow,
                                                          device="cpu"))
    c = int(csel.count)
    assert int(gsel.count) == c > 0
    assert torch.equal(gsel.indices[:c].cpu(), csel.indices[:c])
    for name in cout.columns:
        _same_output(gout.column(name), cout.column(name), c)


_STRING_CASES = [
    ("like", ["s", "%a_%"]), ("like", ["s", "a\\%%", "\\"]),
    ("ilike", ["s", "%É%"]), ("upper", ["s"]), ("substr", ["s", 2, 3]),
    ("concat", ["s", "t"]), ("less_than", ["s", "t"]), ("equal", ["s", "ab"]),
    ("hash64", ["s"]), ("hash32", ["s", 9]), ("length", ["s"]),
    ("castFLOAT8", ["s"]), ("castBIGINT", ["s"]), ("to_date", ["s",
                                                             "YYYY-MM-DD"]),
    ("castVARCHAR", ["f"]), ("castVARCHAR", ["d", 5]), ("to_hex", ["s"]),
    ("levenshtein", ["s", "abc"]), ("castVARBINARY", ["s", 2])]


@pytest.mark.parametrize("case", range(len(_STRING_CASES)),
                         ids=[n for n, _ in _STRING_CASES])
def test_string_plan_on_card_matches_cpu(case):
    """One signature of each family of the string registry, and IN over
    strings, through make_projector on the card and on the CPU at 4,096
    rows (dictionaries of 300 values with multi-byte and empty strings, 5%
    nulls): the same codes and dictionaries, or the same bits."""
    dev = _card()
    import numpy as np
    import pyarrow as pa

    import gandiva_tpu_torch as gt

    name, spec = _STRING_CASES[case]
    B, dt = gt.TreeExprBuilder, gt.dtypes
    rng = np.random.default_rng(case)
    n = 4096
    words = ["", "é", "日本", "2020-03-01", "42", "-3.5"] + [
        "".join(rng.choice(list("abcÉé日 _%"), rng.integers(1, 9)))
        for _ in range(294)]
    valid = rng.random(n) >= 0.05
    arrow = pa.RecordBatch.from_arrays(
        [pa.array(np.array(words, dtype=object)[rng.integers(0, 300, n)],
                  mask=~valid),
         pa.array(np.array(words[::-1], dtype=object)[rng.integers(0, 300,
                                                                   n)]),
         pa.array(rng.standard_normal(n) * 1e3, mask=~valid),
         pa.array(rng.integers(-10**8, 10**8, n), type=pa.int64()).cast(
             pa.decimal128(22, 3)).cast(pa.decimal128(12, 3))],
        names=["s", "t", "f", "d"])
    cpu = gt.from_arrow(arrow, device="cpu")
    schema = dt.Schema([dt.Field(k, c.dtype) for k, c in cpu.columns.items()])
    args = [B.make_field(schema.field(a)) if a in ("s", "t", "f", "d")
            else B.make_string_literal(a) if isinstance(a, str)
            else B.make_int64_literal(a) if name in ("substr", "castVARCHAR",
                                                     "castVARBINARY")
            else B.make_int32_literal(a) for a in spec]
    gt.registry.decimal_ops.ensure_registered([a.dtype for a in args])
    rt = gt.global_registry().lookup_or_raise(
        name, [a.dtype for a in args]).signature.return_type
    exprs = [B.make_expression(B.make_function(name, args, rt),
                               dt.Field("out", rt)),
             B.make_expression(B.make_in_expression_string(
                 args[0] if spec[0] == "s" else B.make_field(
                     schema.field("s")), words[:50]),
                 dt.Field("in", dt.bool_))]
    outs = [gt.make_projector(schema, exprs, use_cache=False, device=d)
            .evaluate_device(b) for d, b in ((dev, cpu.to(dev)),
                                             ("cpu", cpu))]
    for col in ("out", "in"):
        _same_output(outs[0].column(col), outs[1].column(col), n)


@pytest.mark.parametrize("num_hot", [0, 8])
def test_pipeline_on_the_card_matches_the_cpu(num_hot):
    """The configs[4] pipeline over 4 partitions of the card against the
    same pipeline on the CPU: groups, sums, counts and metrics equal; the
    card run launches K4 and K5 (K3 only past one tile of build rows)."""
    import numpy as np

    from gandiva_tpu_torch import parallel

    dev = _card()
    rng = np.random.default_rng(num_hot)
    total, btotal = 1 << 15, 1 << 11
    inputs = ((rng.zipf(1.4, total) % (btotal * 2)).astype(np.int64),
              rng.integers(1, 100, total).astype(np.int64),
              rng.permutation(btotal * 2)[:btotal].astype(np.int64),
              rng.integers(0, 7, btotal).astype(np.int64))
    out = {}
    for d in ("cpu", dev):
        reset_launches()
        out[str(d)] = parallel.run_pipeline_with_retry(
            parallel.make_mesh(4, device=d), *inputs, num_groups=16,
            num_hot=num_hot, hot_capacity=64)
    cpu, card = out["cpu"], out[str(dev)]
    assert min(LAUNCHES["sort_block"], LAUNCHES["aggregate"]) > 0, LAUNCHES
    for a, b in zip(cpu[:3], card[:3]):
        np.testing.assert_array_equal(a, b)
    for k in ("rows_in", "filter_out", "join_out", "agg_groups",
              "bytes_shuffled", "retries"):
        assert cpu[3][k] == card[3][k], k


def test_distributed_step_on_the_card_matches_the_cpu():
    from gandiva_tpu_torch import parallel
    from gandiva_tpu_torch.entrypoints import distributed_step

    dev = _card()
    g = torch.Generator()
    g.manual_seed(5)
    n = 1 << 16
    cols = (torch.randint(0, 1000, (n,), generator=g),
            torch.rand(n, generator=g, dtype=torch.float64),
            torch.rand(n, generator=g) >= 0.05)
    res = {}
    for d in ("cpu", dev):
        mesh = parallel.make_mesh(4, device=d)
        res[str(d)] = distributed_step(mesh, n // 4, num_groups=1024)(
            *(parallel.shard(mesh, c) for c in cols))
    cpu, card = res["cpu"], res[str(dev)]
    assert int(cpu[4]) == int(card[4]) and not bool(card[5])
    for p in range(4):
        c = int(cpu[3][p])
        assert c == int(card[3][p])
        ck, gk = cpu[0][p][:c], card[0][p][:c].cpu()
        co, go = torch.sort(ck).indices, torch.sort(gk).indices
        assert torch.equal(ck[co], gk[go])
        assert torch.equal(cpu[2][p][:c][co], card[2][p][:c].cpu()[go])
        torch.testing.assert_close(card[1][p][:c].cpu()[go], cpu[1][p][:c][co],
                                   rtol=1e-9, atol=0)


def test_nccl_mesh_matches_one_process(tmp_path):
    """With two or more cards: NCCL processes, one card each, dividing a
    4-partition mesh give row-identical pipeline, shuffle and sort results
    to one process holding all four partitions on one card."""
    from test_torch_multiprocess_mesh import run_mesh_workers

    _card()
    cards = torch.cuda.device_count()
    if cards < 2:
        pytest.skip("needs two or more cards for NCCL between processes")
    run_mesh_workers(tmp_path, 4 if cards >= 4 else 2, "cuda", timeout=300)


# ---------------------------------------------------------------------------
# the plan compiler: generated kernels against the eager route on the card
# ---------------------------------------------------------------------------

def _eager(gt):
    return gt.ConfigurationBuilder().with_optimize(False).build()


def _hold_plan_outputs(got, want):
    (gsel, gout), (wsel, wout) = got, want
    c = int(wsel.count)
    assert int(gsel.count) == c
    assert torch.equal(gsel.indices[:c], wsel.indices[:c])
    for name in wout.columns:
        _same_output(gout.column(name), _column_cpu(wout.column(name)), c)


def _column_cpu(c):
    import gandiva_tpu_torch as gt

    return gt.Column(c.data.cpu(), c.validity.cpu(), c.dtype,
                     extra=None if c.extra is None else c.extra.cpu(),
                     dictionary=c.dictionary)


@pytest.mark.parametrize("name", ["configs[0]", "q1", "q6", "q7", "q12",
                                  "q19", "q9", "q16", "q22"])
def test_compiled_plan_on_card_matches_eager(name):
    """The entry points' plans compiled (the default) against the same
    plans with optimize off, on the card: one generated kernel a call,
    nothing eager (the string scans' nodes read their host tables in it;
    Q22's is the substring under a string IN beside a decimal compare),
    the same selection and outputs bit for bit."""
    dev = _card()
    import numpy as np

    import gandiva_tpu_torch as gt
    from gandiva_tpu_torch import entrypoints as e

    if name == "configs[0]":
        rng = np.random.default_rng(1)
        batch = gt.from_columns_numpy(
            {"a": ("int64", rng.integers(0, 1000, 100_003),
                   rng.random(100_003) >= 0.05),
             "b": ("float64", rng.random(100_003),
                   np.ones(100_003, dtype=bool))}, 100_003, device=dev)
        make = e.flagship_plan
    elif name in ("q9", "q16"):
        batch = e.part(20000, seed=2, device=dev)
        make = getattr(e, f"tpch_{name}_part_scan")
    elif name == "q22":
        batch = e.customer(20000, seed=2, device=dev)
        make = e.tpch_q22_customer_scan
    else:
        batch = e.lineitem(100_003, seed=2, device=dev)
        make = getattr(e, f"tpch_{name}_scan")
    comp = make(dev)
    eager = gt.make_filter_project(comp.schema, comp.condition, comp.exprs,
                                   config=_eager(gt), use_cache=False,
                                   device=dev)
    assert comp._program.count("eager") == 0
    reset_launches()
    got = comp.evaluate_device(batch)
    assert LAUNCHES["plan"] == 1
    want = eager.evaluate_device(batch)
    assert LAUNCHES["plan"] == 1
    _hold_plan_outputs(got, want)
    assert "__global__" in comp.dump_hlo()


@pytest.mark.parametrize("part", range(16))
def test_emitters_compiled_on_card_match_eager(part):
    """Every emitter signature (chip_smoke.emitter_plans' ``part`` of 16)
    compiled against the eager route on the card at 4,096 rows with nulls
    and hazard rows; floats by their bits, NaN equal to NaN."""
    dev = _card()
    import numpy as np

    import gandiva_tpu_torch as gt
    from chip_smoke import (EMIT_BATCHES, emitter_column, emitter_plans,
                            same_column)

    assert EMIT_BATCHES == 16
    schema, exprs = emitter_plans(gt)[part]
    rng = np.random.default_rng(part)
    cols = {f.name: (str(f.dtype), *emitter_column(str(f.dtype), f.name[0],
                                                   4096, rng))
            for f in schema}
    batch = gt.from_columns_numpy(cols, 4096, device=dev)
    comp = gt.make_projector(schema, exprs, use_cache=False, device=dev)
    assert comp._program.count("eager") == 0
    got = comp.evaluate_device(batch)
    want = gt.make_projector(schema, exprs, config=_eager(gt),
                             use_cache=False,
                             device=dev).evaluate_device(batch)
    for e in exprs:
        n = e.result_field.name
        assert same_column(got.column(n), _column_cpu(want.column(n))), \
            e.root.to_string()


@pytest.mark.parametrize("part", range(4))
def test_string_emitters_compiled_on_card_match_eager(part):
    """Every string and binary signature with an emitter
    (chip_smoke.string_emitter_plans' ``part`` of 4) compiled against the
    eager route on the card at 4,096 rows, dictionaries of 1,000 values
    with nulls: values, validities and string outputs' dictionaries."""
    dev = _card()
    import numpy as np

    import gandiva_tpu_torch as gt
    from chip_smoke import (STRING_EMIT_BATCHES, same_string_column,
                            string_column, string_emitter_plans)

    assert STRING_EMIT_BATCHES == 4
    schema, exprs, spec, _ = string_emitter_plans(gt)[part]
    rng = np.random.default_rng(part)
    cols = {k: (t, *string_column(t, 4096, rng, name))
            for k, (t, name) in spec.items()}
    batch = gt.from_columns_numpy(cols, 4096, device=dev)
    comp = gt.make_projector(schema, exprs, use_cache=False, device=dev)
    assert comp._program.count("eager") == 0
    got = comp.evaluate_device(batch)
    want = gt.make_projector(schema, exprs, config=_eager(gt),
                             use_cache=False,
                             device=dev).evaluate_device(batch)
    for e in exprs:
        n = e.result_field.name
        assert same_string_column(got.column(n),
                                  _column_cpu(want.column(n))), \
            e.root.to_string()


def test_compiled_routes_on_card_match_eager():
    """A Projector over a selection (the length a device scalar),
    stream_fn, and raise_errors' first message, compiled against eager
    on the card."""
    dev = _card()
    import numpy as np

    import gandiva_tpu_torch as gt
    from gandiva_tpu_torch import entrypoints as e

    filt, proj = e._flagship_plans(dev)
    rng = np.random.default_rng(3)
    n = 50_001
    batch = gt.from_columns_numpy(
        {"a": ("int64", rng.integers(0, 1000, n), rng.random(n) >= 0.05),
         "b": ("float64", rng.random(n), np.ones(n, dtype=bool))}, n,
        device=dev)
    sel = filt.evaluate(batch)
    outs = [gt.make_projector(filt.schema, proj.exprs,
                              gt.SelectionMode.UINT32, config=cfg,
                              use_cache=False, device=dev)
            .evaluate(batch, selection=sel)[0] for cfg in (None, _eager(gt))]
    assert outs[0].equals(outs[1])
    fp = e.flagship_plan(dev)
    fp_e = gt.make_filter_project(fp.schema, fp.condition, fp.exprs,
                                  config=_eager(gt), use_cache=False,
                                  device=dev)
    cols = {k: (c.data[None], c.validity[None])
            for k, c in batch.columns.items()}
    (gi, gc, gp), = fp.stream_fn()(cols)
    (wi, wc, wp), = fp_e.stream_fn()(cols)
    c = int(wc)
    assert int(gc) == c and torch.equal(gi[:c], wi[:c])
    for x, y in zip(gp, wp):
        assert torch.equal(_bits(x[:c]), _bits(y[:c]))
    B, dt = gt.TreeExprBuilder, gt.dtypes
    schema = dt.Schema([dt.Field("a", dt.int64), dt.Field("f", dt.float64)])
    exprs = [B.make_expression(B.make_function("castDECIMAL", [
                 B.make_field(schema.field("f"))], dt.decimal128(4, 2)),
                 dt.Field("c", dt.decimal128(4, 2))),
             B.make_expression(B.make_function("divide", [
                 B.make_field(schema.field("a")),
                 B.make_field(schema.field("a"))], dt.int64),
                 dt.Field("q", dt.int64))]
    bad = gt.from_columns_numpy(
        {"a": ("int64", np.array([1, 0, 2]), np.ones(3, dtype=bool)),
         "f": ("float64", np.array([1.0, 2.0, 1e9]), np.ones(3, dtype=bool))},
        3, device=dev)
    messages = []
    for cfg in (gt.ConfigurationBuilder().with_raise_errors(True).build(),
                gt.ConfigurationBuilder().with_raise_errors(True)
                .with_optimize(False).build()):
        with pytest.raises(gt.EvaluationError) as err:
            gt.make_projector(schema, exprs, config=cfg, use_cache=False,
                              device=dev).evaluate_device(bad)
        messages.append(str(err.value))
    assert messages == ["castDECIMAL: overflow"] * 2
    empty = gt.from_columns_numpy(
        {"a": ("int64", np.zeros(0, dtype=np.int64), np.zeros(0, bool)),
         "b": ("float64", np.zeros(0), np.zeros(0, bool))}, 0, device=dev)
    reset_launches()
    sel, out = fp.evaluate_device(empty)
    assert int(sel.count) == 0 and LAUNCHES["plan"] == 0


def test_device_span_times_its_own_work():
    """A ``device=True`` span's CUDA-event time is positive and at most
    the stretch from its start to the end of its work: its host interval
    plus the queue ahead of it (none here) and its own drain."""
    import time

    from torch.profiler import ProfilerActivity, profile

    from gandiva_tpu_torch import tracing

    dev = _card()
    a = torch.rand(4096, 4096, device=dev)
    tracing.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        torch.cuda.synchronize()
        with tracing.span("work", device=dev):
            for _ in range(8):
                a = a @ a
                a = a / a.norm()
        torch.cuda.synchronize()
        done = time.time_ns()
        with tracing.span("nothing", device=dev):
            pass
    work, nothing = tracing.spans()
    tracing.clear()
    assert 0 < work.device_ms <= (done - work.start) / 1e6
    assert 0 <= nothing.device_ms < work.device_ms


@pytest.mark.parametrize("path", ["q1", "q6", "q7", "q12", "q19",
                                  "pipeline1", "pipeline4"])
def test_every_runtime_sync_is_inside_a_sync_span(path):
    """Every call of the CUDA runtime that makes the host wait, in one
    traced TPC-H scan or pipeline query, lies inside a ``gt.sync.*`` span,
    and each such span holds as many as it counts: the kinds of wait the
    CPU's dispatch test cannot see (a host value copied to the card,
    ``.tolist()``, ``.cpu()``, torch's reads inside its own card kernels)
    included."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    import gandiva_tpu_torch as gt
    from benchmark.harness.trace import SYNC_CALLS
    from gandiva_tpu_torch import entrypoints as e
    from gandiva_tpu_torch import tracing

    dev = _card()
    if path.startswith("pipeline"):
        rng = np.random.default_rng(11)
        n, nb = 1 << 18, 1 << 14
        args = [torch.from_numpy(x).to(dev) for x in (
            rng.integers(0, nb, n), rng.integers(0, 100, n),
            np.arange(nb), rng.integers(0, 5, nb))]
        mesh = gt.parallel.make_mesh(int(path[-1]), device=dev)

        def call():
            return gt.parallel.run_pipeline_with_retry(mesh, *args,
                                                       num_groups=5)
    else:
        plan = getattr(e, f"tpch_{path}_scan")(dev)
        batch = e.lineitem(200_000, 3, dev)

        def call():
            return plan.evaluate_device(batch)
    call()                            # builds and warms outside the trace
    torch.cuda.synchronize()
    tracing.clear()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        call()
    spans = tracing.spans()
    tracing.clear()
    root = spans[0]
    assert root.parent == -1 and [s for s in spans if s.parent == -1] \
        == [root]
    waits = [s for s in spans if s.name.startswith("gt.sync.")]
    syncs = [(ev.name(), ev.start_ns())
             for ev in prof.profiler.kineto_results.events()
             if ev.name() in SYNC_CALLS and "CUDA" not in
             str(ev.device_type()) and root.start <= ev.start_ns()
             <= root.end]
    assert syncs
    outside = [(name, t) for name, t in syncs
               if not any(w.start <= t <= w.end for w in waits)]
    assert not outside, outside
    miscounted = [(w.name, w.counters.get("reads", 1), held)
                  for w in waits
                  for held in [sum(w.start <= t <= w.end for _, t in syncs)]
                  if held != w.counters.get("reads", 1)]
    assert not miscounted, miscounted
