"""gandiva_tpu's own behavioural tests, run a second time against the port.

Each listed test module is executed again with ``gandiva_tpu`` (and the
submodules it imports) standing for ``gandiva_tpu_torch`` on the CPU, and
the listed test functions are called with their parametrize cases (and
pytest's ``monkeypatch`` where one takes it). The reference test files
stay as they are. Tests of features the port does not have yet (profiling,
the jit flag's internals) are left out and named in ROADMAP.md.

The aggregate, sort and join tests hand the port the reference's (JAX)
arrays: the stand-ins for ``gandiva_tpu.ops.hash_aggregate``, ``.groupby``,
``.sort``, ``.hash_join`` and ``.kernels.merge_path`` below turn them into
CPU tensors through ``np.asarray`` and the results into numpy arrays; the
port itself takes torch tensors only. ``test_decimal``'s int128 unit tests and ``test_registry_tail``'s interval
tests hand over ``jnp`` arrays too: the ``gandiva_tpu.utils.int128`` and
``gandiva_tpu.batch`` stand-ins convert them the same way. ``test_join``'s
two ``join_stream``
tests ``jax.jit`` the reference's stream and are left out (ROADMAP.md);
``tests/test_torch_join.py`` holds the port's stream instead. ``test_sort_bitonic`` runs only its
``sort_columns`` case: its other tests test ``bitonic_sort_u32`` and
``operands_to_limbs``, which the port leaves out (ROADMAP.md), so its
stand-in names them only to raise.
"""
import functools
import importlib
import inspect
import os
import sys
import types
from contextlib import contextmanager

import numpy as np
import pytest
import torch

import gandiva_tpu_torch as gt

TESTS = os.path.dirname(os.path.abspath(__file__))

CASES = (
    [("test_differential", "test_arith_differential", {"n": n})
     for n in (17, 1000)]
    + [("test_differential", "test_filter_differential", {"n": n})
       for n in (17, 1000)]
    + [("test_differential", name, {}) for name in (
        "test_comparison_chain_differential", "test_math_differential")]
    + [("test_null_properties", "test_random_trees_match_interpreter",
        {"seed": s}) for s in range(12)]
    + [("test_runtime_errors", name, {}) for name in (
        "test_divide_by_zero_raises", "test_divide_by_zero_default_is_silent",
        "test_divide_by_zero_null_rows_do_not_raise",
        "test_mod_by_zero_raises", "test_float_divide_by_zero_never_raises",
        "test_filter_raises_too", "test_uint16_selection_bound")]
    + [("test_projector_filter", name, {}) for name in (
        "test_tree_exp_builder_if_else",
        "test_projector_arithmetic_with_nulls", "test_filter",
        "test_filter_project_composition_with_nulls", "test_boolean_and_or",
        "test_kleene_null_semantics", "test_in_expr_int", "test_literals",
        "test_to_string", "test_rejects_none", "test_validation_errors",
        "test_registry_introspection",
        "test_evaluate_many_batches_reuses_compile",
        "test_selection_mode_enforced")]
    + [("test_filter_project_fused", "test_fused_equals_unfused", {})]
    + [("test_hash_aggregate", name, {}) for name in (
        "test_group_ids_basic", "test_group_ids_overflow",
        "test_group_ids_many_collisions",
        "test_group_ids_float_keys_not_truncated",
        "test_group_ids_multi_with_nulls")]
    + [("test_hash_aggregate", "test_hash_aggregate_vs_arrow_int",
        {"nulls": nulls, "backend": backend})
       for nulls in (False, True) for backend in ("auto", "pallas_interpret")]
    + [("test_hash_aggregate", "test_pallas_float_values_vs_acero",
        {"dtype": dtype}) for dtype in (np.float32, np.float64)]
    + [("test_hash_aggregate", name, {}) for name in (
        "test_hash_aggregate_float_sum_close", "test_pallas_512_groups_vs_acero",
        "test_pallas_float_nulls_and_null_keys",
        "test_hash_aggregate_pallas_wide_values_and_kinds",
        "test_hash_aggregate_pallas_padding_unaligned",
        "test_hash_aggregate_pallas_overflow_flag")]
    + [("test_registry_tail", "test_unsigned_aggregates",
        {"backend": backend, "dtype": dtype})
       for backend in ("xla", "pallas_interpret")
       for dtype in (np.uint8, np.uint32, np.uint64)]
    + [("test_sort", name, {}) for name in (
        "test_normalize_preserves_order", "test_sort_multi_column",
        "test_sort_padding_goes_last")]
    + [("test_sort", "test_sort_vs_arrow",
        {"ascending": a, "nulls_first": f})
       for a in (True, False) for f in (True, False)]
    + [("test_sort_bitonic", "test_sort_columns_denormalize_roundtrip", {})]
    + [("test_merge_path", "test_two_limb_with_carry", {"n": n})
       for n in (100, 1024, 3000, 5000, 16385)]
    + [("test_merge_path", name, {}) for name in (
        "test_stability_heavy_ties", "test_single_limb_sorted_and_reversed",
        "test_multiple_carries_64bit_payload")]
    + [("test_join", "test_join_small_with_duplicates", {"how": how})
       for how in ("inner", "left", "right", "full", "semi", "anti")]
    + [("test_join", "test_join_nulls_never_match", {"how": how})
       for how in ("inner", "left", "semi", "anti", "full")]
    + [("test_join", name, {}) for name in (
        "test_join_random_differential", "test_join_skewed_zipf",
        "test_join_overflow_flag", "test_gather_payload")]
    + [("test_join", "test_join_multi_key", {"how": how})
       for how in ("inner", "left", "right", "full", "semi", "anti")]
    + [("test_join", "test_join_heavy_duplicate_runs", {})]
    + [("test_join", "test_join_unique_build_fast_path", {"how": how})
       for how in ("inner", "left", "semi", "anti")]
    + [("test_join", "test_join_unique_build_detects_duplicates", {})]
    + [("test_join", "test_probe_ranges_hot_matches_dense", {"dist": dist})
       for dist in ("zipf", "uniform", "allsame")]
    + [("test_plan", name, {}) for name in (
        "test_load_and_evaluate_projector", "test_load_and_evaluate_filter",
        "test_round_trip_to_string",
        "test_decimal_and_binary_literals_round_trip", "test_plan_errors")]
    + [("test_datetime", name, {}) for name in (
        "test_extract_fields", "test_extract_differential_vs_arrow_random",
        "test_date_trunc", "test_add_months_and_last_day",
        "test_timestampdiff_month", "test_datediff_and_date_add",
        "test_timestamp_plus_interval_day_literal",
        "test_timestamp_plus_interval_year_calendar",
        "test_cast_interval_and_column_arithmetic")]
    + [("test_decimal", name, {}) for name in (
        "test_int128_roundtrip_add_sub", "test_int128_mul",
        "test_int128_divmod", "test_int128_pow10",
        "test_decimal_projector_add", "test_decimal_multiply_divide",
        "test_decimal_compare_filter", "test_decimal_abs_round_cast",
        "test_cast_decimal_rescale_and_from_numeric",
        "test_cast_decimal_null_on_overflow", "test_int128_mul256_div_pow10",
        "test_decimal_xlarge_multiply")]
    + [("test_io", name, {}) for name in (
        "test_evaluate_stream", "test_prefetcher_propagates_errors")]
    + [("test_registry_tail", "test_interval_extraction_and_casts", {})]
    + [("test_runtime_errors", name, {}) for name in (
        "test_decimal_divide_by_zero_raises",
        "test_cast_decimal_overflow_raises")]
    + [("test_strings", name, {}) for name in (
        "test_like", "test_like_underscore_and_escape", "test_in_string",
        "test_upper_lower_transforms", "test_transform_chain",
        "test_length_and_substr", "test_string_compare_two_columns",
        "test_string_compare_literal", "test_concat",
        "test_starts_ends_strpos", "test_cast_string_to_number",
        "test_string_hash_partition_consistency",
        "test_dictionary_changes_between_batches", "test_to_hex_from_hex",
        "test_chr_space_literals", "test_cast_varchar_numeric",
        "test_cast_varchar_float32", "test_convert_utf8_round_trip",
        "test_concat_row_fallback_high_cardinality",
        "test_concat_row_fallback_through_transform",
        "test_cast_varchar_computed_numeric",
        "test_cast_varchar_computed_float_with_nulls",
        "test_cast_varchar_decimal",
        "test_like_table_memoized_on_dictionary_identity",
        "test_dict_distinct_ratio_counter_and_cliff")]
    + [("test_datetime", name, {}) for name in (
        "test_to_date_and_is_date", "test_cast_timestamp_from_string",
        "test_interval_and_alias_signatures_visible")]
    + [("test_registry_tail", name, {}) for name in (
        "test_interval_tail_signatures_enumerated",
        "test_cast_varbinary_string", "test_cast_varbinary_numeric")]
    + [("test_projector_filter", "test_in_expr_extended_types", {}),
       ("test_filter_project_fused", "test_fused_with_strings", {})]
)


def _port_on_cpu() -> types.ModuleType:
    """A module named gandiva_tpu whose names are the port's, with the
    entry points that take a device bound to the CPU."""
    mod = types.ModuleType("gandiva_tpu")
    for name in dir(gt):
        if not name.startswith("__"):
            setattr(mod, name, getattr(gt, name))
    for name in ("make_projector", "make_filter", "make_filter_project",
                 "from_arrow", "from_numpy", "make_projector_from_plan",
                 "make_filter_from_plan"):
        setattr(mod, name, functools.partial(getattr(gt, name),
                                             device="cpu"))
    return mod


def _tensor(x):
    return None if x is None else torch.from_numpy(np.array(np.asarray(x)))


def _key(x):
    """A key column as a CPU tensor, unsigned lanes as their signed bits
    (as the port holds normalized keys)."""
    return None if x is None else gt.utils.ints.signed_view(_tensor(x))


def _numpy(x):
    return tuple(_numpy(v) for v in x) if isinstance(x, tuple) \
        else np.asarray(x)


def _aggregate_shim() -> types.ModuleType:
    port = importlib.import_module("gandiva_tpu_torch.ops.hash_aggregate")
    mod = types.ModuleType("gandiva_tpu.ops.hash_aggregate")

    def hash_aggregate(keys, aggs, values, key_valid=None, row_valid=None,
                       **kw):
        res = port.hash_aggregate(
            _tensor(keys), aggs,
            {k: (_tensor(a), _tensor(v)) for k, (a, v) in values.items()},
            key_valid=_tensor(key_valid), row_valid=_tensor(row_valid), **kw)
        return {k: _numpy(v) for k, v in res.items()}

    mod.hash_aggregate = hash_aggregate
    return mod


def _groupby_shim() -> types.ModuleType:
    port = gt.ops.groupby
    mod = types.ModuleType("gandiva_tpu.ops.groupby")

    def group_ids(keys, valid=None, **kw):
        return _numpy(port.group_ids(_tensor(keys), _tensor(valid), **kw))

    def group_ids_multi(key_columns, valids=None, **kw):
        return _numpy(port.group_ids_multi(
            [_tensor(c) for c in key_columns],
            None if valids is None else [_tensor(v) for v in valids], **kw))

    mod.group_ids, mod.group_ids_multi = group_ids, group_ids_multi
    return mod


_UNSIGNED = {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}


def _sort_shim() -> types.ModuleType:
    port = gt.ops.sort
    mod = types.ModuleType("gandiva_tpu.ops.sort")

    def keys_(keys):
        return [port.SortKey(_tensor(k.values), _tensor(k.validity),
                             k.ascending, k.nulls_first) for k in keys]

    def normalize_key(values, ascending=True):
        """The unsigned lanes as numpy's unsigned dtype of their width (the
        port holds them as the bits of the signed type)."""
        u = np.asarray(port.normalize_key(_tensor(values), ascending))
        return u.view(_UNSIGNED[u.itemsize])

    def sort_permutation(keys, length=None):
        return np.asarray(port.sort_permutation(keys_(keys), length))

    def _sort_full(keys, length, carries=()):
        """The reference's 3-tuple: (perm, sorted norms as numpy's unsigned
        dtype of their width, no carries)."""
        perm, norms = port._sort_full(keys_(keys), length)
        return np.asarray(perm), [
            np.asarray(x).view(_UNSIGNED[x.element_size()]) for x in norms], ()

    def sort_columns(keys, payload=(), length=None):
        perm, sk, sp = port.sort_columns(
            keys_(keys), [_tensor(p) for p in payload], length)
        return (np.asarray(perm), [x.numpy() for x in sk],
                [x.numpy() for x in sp])

    mod.SortKey = port.SortKey
    mod.normalize_key, mod.sort_permutation, mod.sort_columns = \
        normalize_key, sort_permutation, sort_columns
    mod._sort_full = _sort_full
    return mod


def _hash_join_shim() -> types.ModuleType:
    port = gt.ops.hash_join
    mod = types.ModuleType("gandiva_tpu.ops.hash_join")

    def result(res):
        return port.JoinResult(*(np.asarray(f) for f in res))

    def join(probe_keys, build_keys, capacity, how="inner", **kw):
        return result(port.join(
            _key(probe_keys), _key(build_keys), capacity, how,
            **{k: v if isinstance(v, (bool, int)) else _tensor(v)
               for k, v in kw.items()}))

    def join_multi(probe_keys_list, build_keys_list, capacity, how="inner",
                   **kw):
        return result(port.join_multi(
            [_key(k) for k in probe_keys_list],
            [_key(k) for k in build_keys_list], capacity, how,
            **{k: [_tensor(x) for x in v] if isinstance(v, list)
               else _tensor(v) for k, v in kw.items()}))

    def gather_payload(res, probe_cols=None, build_cols=None):
        def cols(c):
            return None if c is None else {
                k: (_tensor(v), _tensor(m)) for k, (v, m) in c.items()}

        out, row_ok = port.gather_payload(
            port.JoinResult(*(_tensor(f) for f in res)), cols(probe_cols),
            cols(build_cols))
        return ({k: (np.asarray(v), np.asarray(m))
                 for k, (v, m) in out.items()}, np.asarray(row_ok))

    def _build_ranges_table(sorted_norm, n_valid, perm=None, table_factor=16):
        return _numpy(port._build_ranges_table(
            _key(sorted_norm), _tensor(n_valid), _tensor(perm), table_factor))

    def probe_ranges(fn):
        def run(table, nb, pk_norm, probe_kv, *args):
            start, ln, diag = fn(_tensor(table), nb, _key(pk_norm),
                                 _tensor(probe_kv), *args)
            return (np.asarray(start), np.asarray(ln),
                    {k: np.asarray(v) for k, v in diag.items()})
        return run

    mod.JoinResult = port.JoinResult
    mod.join, mod.join_multi, mod.gather_payload = join, join_multi, \
        gather_payload
    mod._build_ranges_table = _build_ranges_table
    mod._probe_ranges_dense = probe_ranges(port._probe_ranges_dense)
    mod._probe_ranges_hot = probe_ranges(port._probe_ranges_hot)
    return mod


def _merge_path_shim() -> types.ModuleType:
    kernels = importlib.import_module(
        "gandiva_tpu_torch.ops.kernels.merge_path")
    mod = types.ModuleType("gandiva_tpu.ops.kernels.merge_path")

    def merge_sort_u32(limbs, carry=(), w_log2=16, interpret=False):
        """The reference's uint32 comparator limbs packed two to a 64-bit
        word (most significant first; an odd last limb alone, zero-extended,
        which keeps the lexicographic order), sorted by the port's
        ``merge_sort`` at the same tile; the sorted limbs unpacked from the
        sorted words, and the carries (payload limbs) gathered by the
        permutation, as the port gathers payloads."""
        limbs = [np.asarray(x).astype(np.uint64) for x in limbs]
        words = [(hi << np.uint64(32)) | lo
                 for hi, lo in zip(limbs[0::2], limbs[1::2])]
        if len(limbs) % 2:
            words.append(limbs[-1])
        perm, sorted_words = kernels.merge_sort(
            [torch.from_numpy(w.view(np.int64)) for w in words],
            w_log2=w_log2)
        perm = perm.numpy()
        sorted_limbs = []
        for j, w in enumerate(sorted_words.numpy().view(np.uint64)):
            if 2 * j + 1 < len(limbs):
                sorted_limbs.append((w >> np.uint64(32)).astype(np.uint32))
            sorted_limbs.append(w.astype(np.uint32))
        return perm, sorted_limbs, [np.asarray(c)[perm] for c in carry]

    mod.merge_sort_u32 = merge_sort_u32
    return mod


def _sort_bitonic_shim() -> types.ModuleType:
    mod = types.ModuleType("gandiva_tpu.ops.kernels.sort_bitonic")

    def not_ported(*args, **kwargs):
        raise NotImplementedError("bitonic_sort_u32 and operands_to_limbs "
                                  "are not ported (ROADMAP.md)")

    mod.bitonic_sort_u32 = mod.operands_to_limbs = not_ported
    return mod


def _plan_shim() -> types.ModuleType:
    """The port's plan module with its makers bound to the CPU."""
    mod = types.ModuleType("gandiva_tpu.plan")
    for name in dir(gt.plan):
        if not name.startswith("__"):
            setattr(mod, name, getattr(gt.plan, name))
    for name in ("make_projector_from_plan", "make_filter_from_plan"):
        setattr(mod, name, functools.partial(getattr(gt.plan, name),
                                             device="cpu"))
    return mod


def _io_shim() -> types.ModuleType:
    mod = types.ModuleType("gandiva_tpu.io")
    mod.BatchPrefetcher = functools.partial(gt.io.BatchPrefetcher,
                                            device="cpu")
    mod.evaluate_stream = gt.io.evaluate_stream
    return mod


def _int128_shim() -> types.ModuleType:
    """The port's int128 functions on the reference's (jnp) limb arrays:
    arrays in as CPU tensors, limbs out as numpy arrays; static ints
    (shift and power-of-ten counts) pass through."""
    port = importlib.import_module("gandiva_tpu_torch.utils.int128")
    mod = types.ModuleType("gandiva_tpu.utils.int128")

    def wrap(fn):
        def run(*args):
            return _numpy(fn(*(a if isinstance(a, int) else _tensor(a)
                               for a in args)))
        return run

    for name in ("add128", "sub128", "mul_i64", "divmod128", "mul_pow10",
                 "div_pow10_round", "mul256_div_pow10"):
        setattr(mod, name, wrap(getattr(port, name)))
    return mod


def _batch_shim() -> types.ModuleType:
    """The port's Batch and from_arrow (on the CPU), and a Column that
    takes the reference's (jnp) arrays as CPU tensors."""
    mod = types.ModuleType("gandiva_tpu.batch")

    def column(data, validity, dtype, dictionary=None, extra=None):
        return gt.Column(_tensor(data), _tensor(validity), dtype, dictionary,
                         _tensor(extra))

    mod.Batch, mod.Column = gt.Batch, column
    mod.from_arrow = functools.partial(gt.from_arrow, device="cpu")
    return mod


_UTILS = types.ModuleType("gandiva_tpu.utils")
_UTILS.int128 = _int128_shim()
_AGG = _aggregate_shim()
_GROUPBY = _groupby_shim()
_SORT = _sort_shim()
_MERGE_PATH = _merge_path_shim()
_JOIN = _hash_join_shim()
_OPS = types.ModuleType("gandiva_tpu.ops")
_OPS.hash_aggregate, _OPS.groupby, _OPS.sort, _OPS.hash_join = \
    _AGG, _GROUPBY, _SORT, _JOIN

_STAND_INS = {
    "gandiva_tpu": _port_on_cpu(),
    "gandiva_tpu.dtypes": gt.dtypes,
    "gandiva_tpu.expr": gt.expr,
    "gandiva_tpu.expr.nodes": gt.expr.nodes,
    "gandiva_tpu.registry": gt.registry,
    "gandiva_tpu.registry.registry": gt.registry.registry,
    "gandiva_tpu.registry.decimal_ops": gt.registry.decimal_ops,
    "gandiva_tpu.registry.string_ops": gt.registry.string_ops,
    "gandiva_tpu.plan": _plan_shim(),
    "gandiva_tpu.io": _io_shim(),
    "gandiva_tpu.batch": _batch_shim(),
    "gandiva_tpu.utils": _UTILS,
    "gandiva_tpu.utils.int128": _UTILS.int128,
    "gandiva_tpu.ops": _OPS,
    "gandiva_tpu.ops.hash_aggregate": _AGG,
    "gandiva_tpu.ops.groupby": _GROUPBY,
    "gandiva_tpu.ops.sort": _SORT,
    "gandiva_tpu.ops.hash_join": _JOIN,
    "gandiva_tpu.ops.kernels.merge_path": _MERGE_PATH,
    "gandiva_tpu.ops.kernels.sort_bitonic": _sort_bitonic_shim(),
}


@contextmanager
def _port_as_reference():
    saved = {k: sys.modules.get(k) for k in _STAND_INS}
    sys.modules.update(_STAND_INS)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                sys.modules.pop(k, None)
            else:
                sys.modules[k] = v


@functools.lru_cache(maxsize=None)
def _module(stem: str) -> dict:
    path = os.path.join(TESTS, f"{stem}.py")
    with open(path) as f:
        code = compile(f.read(), path, "exec")
    ns = {"__name__": f"port_rerun.{stem}", "__file__": path}
    with _port_as_reference():
        exec(code, ns)
    return ns


def _case_id(stem, name, kwargs) -> str:
    return f"{stem}::{name}" + "".join(
        f"[{getattr(v, '__name__', v)}]" for v in kwargs.values())


@pytest.mark.parametrize("stem,name,kwargs", CASES,
                         ids=[_case_id(*c) for c in CASES])
def test_reference_case_on_port(stem, name, kwargs, monkeypatch):
    ns = _module(stem)
    for alias, stand_in in (("g", _STAND_INS["gandiva_tpu"]),
                            ("hash_aggregate", _AGG.hash_aggregate),
                            ("group_ids", _GROUPBY.group_ids),
                            ("sort_permutation", _SORT.sort_permutation),
                            ("merge_sort_u32", _MERGE_PATH.merge_sort_u32),
                            ("join", _JOIN.join)):
        assert alias not in ns or ns[alias] is stand_in, alias
    if "monkeypatch" in inspect.signature(ns[name]).parameters:
        kwargs = {**kwargs, "monkeypatch": monkeypatch}
    with _port_as_reference():
        ns[name](**kwargs)
