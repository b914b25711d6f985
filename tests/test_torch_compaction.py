"""The port's compactions on the CPU (the plain versions that CPU tensors
take): kernel K1's against gandiva_tpu's compact_sort and its Pallas
compact_columns, and kernel K2's against the Pallas
compact_pallas_u32_fragnet and against K1's, the Pallas kernels run in
interpret mode as tests/test_compaction_pallas.py runs them."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental import pallas as pl

from gandiva_tpu.compiler import selection as g_sel
from gandiva_tpu.ops import compaction as g_comp
from gandiva_tpu.ops.kernels import compaction_pallas as cp
from gandiva_tpu_torch.compiler import selection as t_sel
from gandiva_tpu_torch.ops import compaction as t_comp
from gandiva_tpu_torch.ops.kernels import LAUNCHES, reset_launches
from gandiva_tpu_torch.ops.kernels.compaction import (compact_columns,
                                                      compact_columns_cuda)
from gandiva_tpu_torch.ops.kernels.compaction_fragnet import (
    compact_fragnet_columns, compact_fragnet_cuda)


@pytest.fixture
def interpret_mode(monkeypatch):
    orig = pl.pallas_call

    def interp(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(cp.pl, "pallas_call", interp)


def _inputs(n, density, seed):
    rng = np.random.default_rng(seed)
    mask = rng.random(n) < density
    return mask, [rng.integers(-10**12, 10**12, n), rng.random(n),
                  rng.random(n) < 0.5]


def _many_inputs(n, density, seed):
    """Ten payloads of every width: more than one scatter launch moves."""
    rng = np.random.default_rng(seed)
    mask = rng.random(n) < density
    return mask, [rng.integers(-10**12, 10**12, n), rng.random(n),
                  rng.integers(-2**31, 2**31, n).astype(np.int32),
                  rng.random(n).astype(np.float32),
                  rng.integers(-2**15, 2**15, n).astype(np.int16),
                  rng.random(n) < 0.5,
                  rng.integers(-128, 128, n).astype(np.int8),
                  rng.integers(-2**40, 2**40, n),
                  -rng.random(n), rng.integers(-5, 5, n)]


def _port(mask, payload):
    idx, count, cols = t_comp.compact_best(
        torch.from_numpy(mask), [torch.from_numpy(p) for p in payload])
    return idx.numpy(), int(count), [c.numpy() for c in cols]


def _same_prefix(port, ref_idx, ref_count, ref_cols):
    idx, count, cols = port
    assert count == int(ref_count)
    np.testing.assert_array_equal(idx[:count].astype(np.uint32),
                                  np.asarray(ref_idx)[:count])
    for got, want in zip(cols, ref_cols):
        want = np.asarray(want)[:count]
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got[:count], want)


@pytest.mark.parametrize("density", [0.0, 0.02, 0.43, 0.97, 1.0])
def test_compact_best_matches_pallas_kernel(interpret_mode, density):
    mask, payload = _inputs(8192, density, int(density * 100))
    ref_idx, ref_cols, ref_count = cp.compact_columns(
        jnp.asarray(mask), [jnp.asarray(p) for p in payload])
    _same_prefix(_port(mask, payload), ref_idx, ref_count, ref_cols)


def test_compact_best_many_payloads_matches_pallas_kernel(interpret_mode):
    mask, payload = _many_inputs(8192, 0.43, 5)
    ref_idx, ref_cols, ref_count = cp.compact_columns(
        jnp.asarray(mask), [jnp.asarray(p) for p in payload])
    assert len(ref_cols) == len(payload) == 10
    _same_prefix(_port(mask, payload), ref_idx, ref_count, ref_cols)


@pytest.mark.parametrize("n", [5000, 8192])
def test_compact_best_many_payloads_matches_compact_sort(n):
    mask, payload = _many_inputs(n, 0.37, n)
    ref_idx, ref_count, ref_cols = g_comp.compact_sort(
        jnp.asarray(mask), [jnp.asarray(p) for p in payload])
    _same_prefix(_port(mask, payload), ref_idx, ref_count, ref_cols)


@pytest.mark.parametrize("n,density", [(8192, 0.0), (8192, 0.43),
                                       (8192, 1.0), (5000, 0.3),
                                       (5000, 0.97), (1, 1.0)])
def test_compact_best_matches_compact_sort(n, density):
    mask, payload = _inputs(n, density, n + int(density * 10))
    ref_idx, ref_count, ref_cols = g_comp.compact_sort(
        jnp.asarray(mask), [jnp.asarray(p) for p in payload])
    _same_prefix(_port(mask, payload), ref_idx, ref_count, ref_cols)


def test_compact_sort_matches_reference_whole_buffers():
    """The sort formulation is stable on the same 1-bit key, so even the
    tail (the dropped rows, permuted) matches."""
    mask, payload = _inputs(5000, 0.37, 3)
    ref_idx, ref_count, ref_cols = g_comp.compact_sort(
        jnp.asarray(mask), [jnp.asarray(p) for p in payload])
    idx, count, cols = t_comp.compact_sort(
        torch.from_numpy(mask), [torch.from_numpy(p) for p in payload])
    assert int(count) == int(ref_count)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    for got, want in zip(cols, ref_cols):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_compact_mask_and_values():
    mask, payload = _inputs(3000, 0.5, 11)
    idx, count = t_comp.compact_mask(torch.from_numpy(mask))
    ref_idx, ref_count = g_comp.compact_mask(jnp.asarray(mask))
    c = int(ref_count)
    assert int(count) == c
    np.testing.assert_array_equal(idx.numpy()[:c], np.asarray(ref_idx)[:c])
    packed, count = t_comp.compact_values(torch.from_numpy(mask),
                                          torch.from_numpy(payload[1]))
    ref_packed, _ = g_comp.compact_values(jnp.asarray(mask),
                                          jnp.asarray(payload[1]))
    np.testing.assert_array_equal(packed.numpy()[:c],
                                  np.asarray(ref_packed)[:c])


# ---------------------------------------------------------------------------
# capacity and index_dtype, against the reference
# ---------------------------------------------------------------------------

_INDEX_DTYPES = ["uint32", "int32", "uint64", "int64", "uint16"]


@pytest.mark.parametrize("capacity", [None, 0, 4, 1377, 3000, 3100])
@pytest.mark.parametrize("index_dtype", _INDEX_DTYPES)
def test_compact_mask_capacity_and_index_dtype_vs_reference(index_dtype,
                                                            capacity):
    """The whole capacity-sized buffer equals the reference's (survivors
    past capacity dropped, the tail zero) and count stays the full count;
    indices of an unsigned type come as the signed bits of its width."""
    mask, _ = _inputs(3000, 0.5, 17)
    idx, count = t_comp.compact_mask(torch.from_numpy(mask), capacity,
                                     getattr(torch, index_dtype))
    ref_idx, ref_count = g_comp.compact_mask(jnp.asarray(mask), capacity,
                                             getattr(jnp, index_dtype))
    ref = np.asarray(ref_idx)
    assert int(count) == int(ref_count) == int(mask.sum())
    assert idx.dtype == t_comp.index_storage(getattr(torch, index_dtype))
    assert idx.element_size() == ref.itemsize
    got = idx.numpy().view(ref.dtype)
    if capacity is None:
        c = int(count)
        np.testing.assert_array_equal(got[:c], ref[:c])
    else:
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("capacity", [0, 5, 700, 1000, 1200])
@pytest.mark.parametrize("column", [0, 1, 2])
def test_compact_values_capacity_vs_reference(column, capacity):
    mask, payload = _inputs(1000, 0.7, 23)
    values = payload[column]
    packed, count = t_comp.compact_values(torch.from_numpy(mask),
                                          torch.from_numpy(values), capacity)
    ref, ref_count = g_comp.compact_values(jnp.asarray(mask),
                                           jnp.asarray(values), capacity)
    assert int(count) == int(ref_count)
    assert packed.numpy().dtype == values.dtype
    np.testing.assert_array_equal(packed.numpy(), np.asarray(ref))


@pytest.mark.parametrize("capacity", [None, 4, 10, 12])
@pytest.mark.parametrize("mode", ["UINT16", "UINT32", "UINT64"])
def test_selection_from_mask_capacity_vs_reference(mode, capacity):
    """The reference's example: 7 survivors of 10 rows at capacity 4 give
    indices [0, 2, 3, 5] and count 7."""
    mask = np.array([1, 0, 1, 1, 0, 1, 1, 0, 1, 1], bool)
    got = t_sel.SelectionVector.from_mask(
        torch.from_numpy(mask), t_sel.SelectionMode[mode], capacity)
    ref = g_sel.SelectionVector.from_mask(
        jnp.asarray(mask), g_sel.SelectionMode[mode], capacity)
    assert int(got.count) == int(ref.count) == 7 and len(got) == 7
    assert got.capacity == ref.capacity
    assert got.indices.dtype == t_sel.mode_index_dtype(got.mode)
    np.testing.assert_array_equal(got.to_numpy(), ref.to_numpy())
    assert got.to_numpy().dtype == ref.to_numpy().dtype
    if capacity == 4:
        assert got.indices.tolist() == [0, 2, 3, 5]
    if capacity is not None:
        np.testing.assert_array_equal(got.indices.numpy(),
                                      np.asarray(ref.indices))


@pytest.mark.parametrize("index_dtype", _INDEX_DTYPES)
def test_compact_sort_and_best_index_dtype_vs_reference(index_dtype):
    mask, payload = _inputs(2000, 0.4, 29)
    tdt, jdt = getattr(torch, index_dtype), getattr(jnp, index_dtype)
    idx, count, cols = t_comp.compact_sort(
        torch.from_numpy(mask), [torch.from_numpy(p) for p in payload], tdt)
    ref_idx, ref_count, ref_cols = g_comp.compact_sort(
        jnp.asarray(mask), [jnp.asarray(p) for p in payload], jdt)
    ref = np.asarray(ref_idx)
    assert int(count) == int(ref_count)
    np.testing.assert_array_equal(idx.numpy().view(ref.dtype), ref)
    for got, want in zip(cols, ref_cols):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    best, count, _ = t_comp.compact_best(torch.from_numpy(mask), (), tdt)
    c = int(count)
    assert best.dtype == idx.dtype
    np.testing.assert_array_equal(best.numpy().view(ref.dtype)[:c], ref[:c])
    assert t_comp.index_storage(np.dtype(index_dtype)) == best.dtype


def test_index_dtype_and_capacity_refuse_what_they_cannot_hold():
    mask = torch.ones(8, dtype=torch.bool)
    with pytest.raises(ValueError, match="integer"):
        t_comp.compact_mask(mask, index_dtype=torch.float32)
    with pytest.raises(ValueError, match="integer"):
        t_comp.compact_mask(mask, index_dtype=np.float64)
    with pytest.raises(ValueError, match="non-negative"):
        t_comp.compact_mask(mask, capacity=-1)


def test_cpu_tensors_take_the_plain_version():
    reset_launches()
    mask, payload = _inputs(4096, 0.5, 1)
    idx, cols, count = compact_columns(torch.from_numpy(mask),
                                       [torch.from_numpy(payload[0])])
    assert LAUNCHES["compact"] == 0
    assert int(count) == int(mask.sum())
    with pytest.raises(ValueError, match="CUDA tensors"):
        compact_columns_cuda(torch.from_numpy(mask), [])


def test_empty_mask():
    idx, count, cols = t_comp.compact_best(
        torch.zeros(0, dtype=torch.bool), [torch.zeros(0)])
    assert int(count) == 0 and idx.shape == (0,) and cols[0].shape == (0,)


@pytest.mark.parametrize("bad", ["mask_dtype", "length", "too_many",
                                 "strided", "wide"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    n = 64
    mask = torch.ones(n, dtype=torch.bool)
    cols = [torch.zeros(n)]
    if bad == "mask_dtype":
        mask = mask.to(torch.uint8)
    elif bad == "length":
        cols = [torch.zeros(n + 1)]
    elif bad == "too_many":
        # 2^31 rows overflow the int32 indices; a broadcast mask costs no
        # memory, and the row bound is checked before the layout
        mask = torch.ones(1, dtype=torch.bool).expand(1 << 31)
        cols = []
    elif bad == "strided":
        cols = [torch.zeros(2 * n)[::2]]
    else:
        cols = [torch.zeros(n, dtype=torch.complex128)]
    with pytest.raises(ValueError):
        compact_columns(mask, cols)


# ---------------------------------------------------------------------------
# K2 (single-pass look-back compaction): its plain version, which CPU
# tensors take
# ---------------------------------------------------------------------------

def _fragnet(mask, payload):
    idx, count, cols = t_comp.compact_fragnet(
        torch.from_numpy(mask), [torch.from_numpy(p) for p in payload])
    return idx.numpy(), int(count), [c.numpy() for c in cols]


@pytest.mark.parametrize("density", [0.0, 0.03, 0.5, 0.97, 1.0])
def test_compact_fragnet_matches_pallas_fragnet(interpret_mode, density):
    """Three uint32 payloads at 4 · BLOCK rows, as the reference's own test
    drives its fragment-network kernel."""
    rng = np.random.default_rng(int(density * 77) + 1)
    n = 4 * cp.BLOCK
    mask = rng.random(n) < density
    pay = [rng.integers(0, 2**32, n, dtype=np.uint32) for _ in range(3)]
    ref, ref_count = cp.compact_pallas_u32_fragnet(
        jnp.asarray(mask), [jnp.asarray(p).view(jnp.int32) for p in pay])
    idx, count, cols = _fragnet(mask, pay)
    assert count == int(ref_count) == int(mask.sum())
    np.testing.assert_array_equal(idx[:count], np.nonzero(mask)[0])
    for got, want, p in zip(cols, ref, pay):
        assert got.dtype == np.uint32
        np.testing.assert_array_equal(got[:count],
                                      np.asarray(want).view(np.uint32)[:count])
        np.testing.assert_array_equal(got[:count], p[mask])
        assert not got[count:].any()       # zero past count
    assert not idx[count:].any()


def test_compact_fragnet_matches_pallas_fragnet_small_blocks(interpret_mode):
    rng = np.random.default_rng(5)
    rows = 32
    n = 3 * rows * 128
    mask = rng.random(n) < 0.21
    pay = rng.integers(0, 2**31, n, dtype=np.int32)
    (ref,), ref_count = cp.compact_pallas_u32_fragnet(
        jnp.asarray(mask), [jnp.asarray(pay)], rows_per_block=rows)
    idx, count, (got,) = _fragnet(mask, [pay])
    assert count == int(ref_count)
    np.testing.assert_array_equal(got[:count], np.asarray(ref)[:count])


@pytest.mark.parametrize("n,density", [(0, 0.5), (1, 1.0), (4095, 0.5),
                                       (5000, 0.3), (8192, 0.97),
                                       (12289, 0.0), (12289, 1.0)])
def test_compact_fragnet_matches_k1(n, density):
    """K2's plain version against K1's on int64, float64 and bool payloads,
    ragged n and n = 0; ten payloads as well."""
    mask, payload = _inputs(n, density, n + 1)
    got = _fragnet(mask, payload)
    _same_prefix(got, *_port_k1(mask, payload))
    mask, payload = _many_inputs(n, density, n + 2)
    _same_prefix(_fragnet(mask, payload), *_port_k1(mask, payload))


def _port_k1(mask, payload):
    idx, count, cols = _port(mask, payload)
    return idx.astype(np.uint32), count, cols


def test_compact_fragnet_takes_plain_version_only_on_cpu():
    reset_launches()
    mask = torch.ones(64, dtype=torch.bool)
    compact_fragnet_columns(mask, [torch.zeros(64)])
    assert LAUNCHES["compact_fragnet"] == 0
    with pytest.raises(ValueError, match="CUDA tensors"):
        compact_fragnet_cuda(mask, [])
    with pytest.raises(ValueError, match="device"):
        t_comp.compact_fragnet(torch.ones(64, dtype=torch.bool,
                                          device="meta"))


def test_library_names_hash_only_the_headers_a_source_includes(
        tmp_path, monkeypatch):
    """A library's name follows its source and the headers that source
    includes, through other headers too; an edit to any other header leaves
    it as it was."""
    from gandiva_tpu_torch.ops.kernels import build

    (tmp_path / "a.cu").write_text('#include <cstdint>\n#include "x.cuh"\n')
    (tmp_path / "b.cu").write_text('  #  include "y.h"\n')
    (tmp_path / "x.cuh").write_text('#pragma once\n#include "z.cuh"\n')
    (tmp_path / "y.h").write_text("// y\n")
    (tmp_path / "z.cuh").write_text("// z\n")
    (tmp_path / "unused.cuh").write_text("// unused\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    assert build.headers("a") == [tmp_path / "x.cuh", tmp_path / "z.cuh"]
    assert build.headers("b") == [tmp_path / "y.h"]
    before = {n: build.library_path(n) for n in ("a", "b")}
    (tmp_path / "unused.cuh").write_text("// edited\n")
    assert {n: build.library_path(n) for n in ("a", "b")} == before
    (tmp_path / "z.cuh").write_text("// z, edited\n")
    assert build.library_path("a") != before["a"]
    assert build.library_path("b") == before["b"]
    (tmp_path / "y.h").write_text("// y, edited\n")
    assert build.library_path("b") != before["b"]

