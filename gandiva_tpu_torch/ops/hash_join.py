"""Join: inner/left/right/full/semi/anti over 64-bit keys (from
gandiva_tpu.ops.hash_join).

Behavioural oracle: pyarrow.acero's 'hashjoin' Declaration (BASELINE
configs[3] — 1B×10M skewed probe/build). The design is the reference's:

- build side: sort by normalized key once (``_sort_full``: kernel K4 once,
  then K3 every round, on a card), so duplicate build keys become
  contiguous runs and a probe match is a [start, start + len) range into
  sorted order; then place one (key lo, key hi, start, len) int32 entry per
  run into a linear-probed table of ``T + nb`` slots, by the closed-form
  first-fit placement (a second sort, of the runs' home slots); on a card
  the run detection and the placement are the two scans of
  ``csrc/join_build.cu``;
- probe side: each probe key resolves to its (start, len) by walking its
  chain from its home slot; on a card one thread a row walks it in the one
  launch of ``csrc/join_probe.cu``, for every probe size and skew. CPU
  tensors take the reference's chain: one 16-byte table gather, the few
  unresolved rows compacted (kernel K2's plain version) and walked a round
  at a time; probes of 2^22 rows or more first resolve a sampled set of
  hot keys without touching the table and compact only the cold rows;
- output expansion: rows explode into a fixed-capacity (probe_idx,
  build_idx) pair buffer through exclusive-cumsum offsets, each pair slot
  finding its probe row by a binary search of the rows' running ends (the
  reference scatters run starts and fills by cummax: the same rows); a
  unique build whose every probe row matches takes the identity instead;
  capacity overflow is reported, not raised; with no capacity the buffer
  holds the pairs emitted (the identity's probe rows, or the pairs' total
  read once, ``gt.sync.join_total``) and never overflows;
- right/full joins: matched sorted build rows by ±1 marks and a cumsum,
  then the unmatched build rows appended.

Null semantics (SQL): null keys never match; left/right/full emit them with
the other side null.

Every function takes torch tensors and runs where they lie: CUDA tensors
take the kernels, CPU tensors their plain versions (only when the caller
put them there). The table, its placement and the hash are the reference's
bit for bit, so ``JoinTable.table``, the residue sizes and
``probe_diagnostics`` equal its own. What the TPU needed and the card does
not is gone: 64-bit keys stay int64 (no 32-bit limb pairs, apart from the
table's own int32 layout), compactions take any n (no block padding),
scatters write into their targets with a dump slot (no fresh-zero scatter
and select), and the hot keys resolve by ``searchsorted`` over the sorted
hot set (no [n, 64] compare matrix for the MXU).

Data-dependent loops (the CPU route's chain walks and hot-key fallback, the
choice of the identity expansion) are Python loops or branches that read
one flag from the device per round: one host sync each. A walk is bounded
only by the table's size, the one bound that cannot cut a chain. Nothing
else syncs the host: no ``.item()``, no boolean-mask indexing, no
``nonzero``; the card's probe kernel syncs nothing.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .. import tracing
from ..utils.hashing import hash32
from ..utils.ints import signed_view, widen
from .compaction import compact_fragnet, compact_sort
from .groupby import table_size_for
from .kernels.join_build import build_ranges_cuda
from .kernels.join_probe import probe_ranges_cuda
from .sort import SortKey, _sort_full, _widen, normalize_key, sort_permutation

_HOWS = ("inner", "left", "right", "full", "semi", "anti")
_FAST_HOWS = ("inner", "left", "semi", "anti")
_I64_MAX = (1 << 63) - 1
_MAX_ROWS = 1 << 31
_TABLE_BUDGET = 1536 << 20      # bytes of table: see _build_ranges_table
_HOT_MIN_ROWS = 1 << 22         # hot-key machinery pays off only at scale


class JoinResult(NamedTuple):
    probe_idx: torch.Tensor    # int32[capacity]; -1 ⇒ no probe row
    build_idx: torch.Tensor    # int32[capacity]; -1 ⇒ no build row
    count: torch.Tensor        # int32 0-d: valid pair rows
    overflow: torch.Tensor     # bool 0-d: capacity exceeded


class JoinTable(NamedTuple):
    """The compiled build side — the Make half of Make-once/Evaluate-many
    applied to the join: build the table once, then probe any number of
    chunks against it (``probe_chunk`` / ``join_stream``)."""
    table: torch.Tensor        # [T_tot, 4] int32 (key_lo, key_hi, start, len)
    perm: torch.Tensor         # int32[nb] sorted-order → original row
    sorted_exists: torch.Tensor  # bool[nb] rows that exist, sorted order
    n_build_valid: torch.Tensor  # int32 0-d: valid-key row count
    all_unique: torch.Tensor   # bool 0-d: every build run has length 1


def _exclusive_cumsum(x):
    """(exclusive prefix sums in x's dtype, the total as a 0-d tensor)."""
    c = torch.cumsum(x, 0, dtype=x.dtype)
    total = c[-1] if x.shape[0] else torch.zeros((), dtype=x.dtype,
                                                  device=x.device)
    return c - x, total


def _check_how(how: str) -> None:
    if how not in _HOWS:
        raise ValueError(f"unknown join type {how!r}")


def _check_rows(n: int, what: str) -> None:
    if n >= _MAX_ROWS:
        raise ValueError(f"a join takes fewer than 2^31 {what} rows (its "
                         f"indices are int32), got {n}")


def _full(n: int, value, dtype, device) -> torch.Tensor:
    return torch.full((n,), value, dtype=dtype, device=device)


def _scalar(value, dtype, device) -> torch.Tensor:
    """A 0-d device tensor filled on the device (no host-to-device copy)."""
    return torch.full((), value, dtype=dtype, device=device)


def _limbs(x64: torch.Tensor):
    """The (lo, hi) 32-bit words of int64 keys as int32, as the table holds
    them."""
    lo = (((x64 & 0xFFFF_FFFF) ^ 0x8000_0000) - 0x8000_0000).to(torch.int32)
    return lo, (x64 >> 32).to(torch.int32)


def _scatter_back(dst: torch.Tensor, index: torch.Tensor,
                  src) -> torch.Tensor:
    """``dst`` with dst[index] = src (a tensor or a number), where
    index == len(dst) is a dump slot for the rows that write nothing."""
    buf = torch.cat([dst, dst.new_zeros(1)])
    if isinstance(src, torch.Tensor):
        buf.scatter_(0, index, src.to(buf.dtype))
    else:
        buf.scatter_(0, index, src)
    return buf[:-1]


def _walk(table, pos, lo, hi, unres, start, ln):
    """Linear-probe chain walk: each round gathers one 16-byte slot per
    unresolved row and resolves it on a hit (its start and len) or on an
    empty slot (absent). Chains run un-wrapped into the slack tail, so the
    table's size bounds every walk. One host sync per round."""
    for _ in range(table.shape[0]):
        with tracing.sync("walk"):
            pending = bool(unres.any())
        if not pending:
            break
        g = table.index_select(0, torch.where(unres, pos, 0))
        occ = g[:, 3] > 0
        hit = occ & (g[:, 0] == lo) & (g[:, 1] == hi)
        take = unres & hit
        start = torch.where(take, g[:, 2], start)
        ln = torch.where(take, g[:, 3], ln)
        unres = unres & occ & ~hit
        pos = pos + 1
    return start, ln


def _unsigned_max(norm: torch.Tensor) -> int:
    """The all-ones norm of ``norm``'s width, widened as ``_widen`` widens."""
    bits = 8 * norm.element_size()
    return -1 if bits == 64 else (1 << bits) - 1


def build_join_table(build_keys, build_valid=None, build_exists=None,
                     build_length=None, how: str = "inner",
                     table_factor: int = 16) -> JoinTable:
    """Compile the build side once into a JoinTable. Probe any number of
    chunks against it with ``probe_chunk`` (the streaming path of BASELINE
    configs[3] at full 1B×10M scale).

    ``how`` must match the join type the table will be probed with: the
    fast-expansion types (inner/left/semi/anti) store ORIGINAL build rows
    for length-1 runs, while right/full store sorted positions throughout
    (their unmatched-build pass walks sorted run ranges)."""
    with tracing.span("gt.join.build", device=build_keys.device):
        how = how.lower()
        _check_how(how)
        nb = build_keys.shape[0]
        _check_rows(nb, "build")
        dev = build_keys.device
        if build_exists is None:
            build_exists = torch.ones(nb, dtype=torch.bool, device=dev)
        if build_length is not None:
            build_exists = build_exists & (torch.arange(nb, device=dev)
                                           < build_length)
        build_kv = build_exists if build_valid is None \
            else (build_valid & build_exists)

        # ---- sort build keys; key-invalid rows sort last (K4, then K3) ---
        perm, (sorted_norm,) = _sort_full(
            [SortKey(build_keys, validity=build_kv, nulls_first=False)], None)
        if build_keys.is_floating_point():
            # the sort zeroes NaN norms (its rank word places NaN); the table
            # holds the key's own norm, as the reference's does
            sorted_norm = normalize_key(build_keys).index_select(0, perm)
        sorted_valid = build_kv.index_select(0, perm)
        sorted_exists = build_exists.index_select(0, perm)
        n_build_valid = build_kv.sum(dtype=torch.int32)
        # invalid rows sit past the valid prefix; pin them to the max norm, as
        # the reference does (run lengths clamp to the valid prefix, so a real
        # max-valued key stays correct)
        sorted_keys = torch.where(sorted_valid, _widen(sorted_norm),
                                  _unsigned_max(sorted_norm))
        fast_how = how in _FAST_HOWS
        table, all_unique = _build_ranges_table(
            sorted_keys, n_build_valid, perm if fast_how else None,
            table_factor)
        return JoinTable(table, perm, sorted_exists, n_build_valid, all_unique)


def join(probe_keys, build_keys, capacity: Optional[int],
         how: str = "inner",
         probe_valid=None, build_valid=None,
         probe_length=None, build_length=None,
         probe_exists=None, build_exists=None,
         build_unique: bool = False) -> JoinResult:
    """Join probe×build on 64-bit keys; returns index pairs into the
    original row orders (gather payloads with them).

    ``*_valid``: key validity (null keys never match but their rows still
    emit on the outer sides). ``*_length`` / ``*_exists``: row existence —
    non-existing rows (padding, unfilled shuffle slots) never emit at all.
    ``capacity`` None: the output holds the pairs emitted (``probe_chunk``).
    """
    how = how.lower()
    _check_how(how)
    jt = build_join_table(build_keys, build_valid=build_valid,
                          build_exists=build_exists,
                          build_length=build_length, how=how)
    return probe_chunk(jt, probe_keys, capacity, how,
                       probe_valid=probe_valid, probe_exists=probe_exists,
                       probe_length=probe_length, build_unique=build_unique)


def _general_expand(how, lo, ln, probe_kv, probe_exists, perm, C,
                    extra=0):
    """Explode each probe row into its emitted pairs: (probe_out, build_out,
    total pairs as an int64 0-d tensor, the capacity). ``lo`` is a sorted
    position for len > 1 runs and, for the fast-expansion types, the
    ORIGINAL build row for len == 1 runs. ``C`` None: the pairs' total
    plus ``extra`` (rows the caller appends), read once."""
    np_ = lo.shape[0]
    nb = perm.shape[0]
    dev = lo.device
    cnt = torch.where(probe_kv, ln, 0)
    if how == "semi":
        emit = cnt.clamp(max=1)
    elif how == "anti":
        emit = (probe_exists & (cnt == 0)).to(torch.int32)
    elif how in ("left", "full"):
        emit = torch.where(probe_exists, cnt.clamp(min=1), 0)
    else:  # inner, right probe-part
        emit = cnt
    offsets, _ = _exclusive_cumsum(emit)
    total = emit.sum(dtype=torch.int64)
    if C is None:
        with tracing.sync("join_total"):
            C = int(total + extra)
    if np_ == 0:
        none = _full(C, -1, torch.int32, dev)
        return none, none.clone(), total, C
    # each pair slot takes the probe row whose pairs [offset, offset + emit)
    # hold it: the first row whose running end passes the slot (a binary
    # search; a scatter of run starts would send every row that emits
    # nothing to one dump slot, all of them contending for it)
    r = torch.arange(C, dtype=torch.int32, device=dev)
    slot_probe = torch.searchsorted(offsets + emit, r, right=True).clamp(
        max=np_ - 1).to(torch.int32)
    in_probe_part = r < total
    p = slot_probe.long()
    # one packed 12-byte row gather instead of three element gathers
    g = torch.stack([offsets, cnt, lo], 1).index_select(0, p)
    j = r - g[:, 0]
    matched = g[:, 1] > 0
    if how in ("semi", "anti") or nb == 0:
        build_out = _full(C, -1, torch.int32, dev)
    else:
        bsorted = (g[:, 2] + j).clamp(0, nb - 1).long()
        bperm = perm.index_select(0, bsorted)
        if how in _FAST_HOWS:
            # len-1 entries already carry the original build row
            bperm = torch.where(g[:, 1] == 1, g[:, 2], bperm)
        build_out = torch.where(matched, bperm, -1)
    probe_out = torch.where(in_probe_part, slot_probe, -1)
    build_out = torch.where(in_probe_part, build_out, -1)
    return probe_out, build_out, total, C


def _unique_expand(how, lo, matched, C):
    """Unique build, every probe row emitting exactly one output: the
    output is the identity over probe rows — pure elementwise."""
    np_ = lo.shape[0]
    dev = lo.device
    r = torch.arange(C, dtype=torch.int32, device=dev)
    if how == "anti":  # every row matched ⇒ empty result
        return (_full(C, -1, torch.int32, dev), _full(C, -1, torch.int32, dev),
                torch.zeros((), dtype=torch.int64, device=dev))
    total = _scalar(np_, torch.int64, dev)
    m = min(np_, C)
    probe_out = torch.where(r < m, r, -1)
    build_out = _full(C, -1, torch.int32, dev)
    if how == "inner":
        build_out[:m] = lo[:m]
    elif how == "left":
        build_out[:m] = torch.where(matched[:m], lo[:m], -1)
    return probe_out, build_out, total


def probe_chunk(jt: JoinTable, probe_keys, capacity: Optional[int],
                how: str = "inner", probe_valid=None, probe_exists=None,
                probe_length=None, build_unique: bool = False) -> JoinResult:
    """Evaluate one probe chunk against a compiled JoinTable (the Evaluate
    half of Make-once/Evaluate-many). ``how`` must equal the ``how`` the
    table was built with.

    ``build_unique`` (a PK-FK declaration) only adds the contract check:
    the general path detects a unique build itself and takes the identity
    expansion; duplicate build keys then surface through ``overflow``.

    ``capacity`` None sizes the output by the pairs emitted: the probe's
    rows on the identity expansion, else the total read from the device."""
    with tracing.span("gt.join.probe", device=probe_keys.device):
        how = how.lower()
        _check_how(how)
        np_ = probe_keys.shape[0]
        _check_rows(np_, "probe")
        dev = probe_keys.device
        perm = jt.perm
        if probe_exists is None:
            probe_exists = torch.ones(np_, dtype=torch.bool, device=dev)
        if probe_length is not None:
            probe_exists = probe_exists & (torch.arange(np_, device=dev)
                                           < probe_length)
        probe_kv = probe_exists if probe_valid is None \
            else (probe_valid & probe_exists)

        fast_how = how in _FAST_HOWS
        lo, ln = _probe_ranges(jt.table, perm.shape[0],
                               normalize_key(probe_keys), probe_kv)
        uniq = jt.all_unique if fast_how \
            else torch.zeros((), dtype=torch.bool, device=dev)

        # ---- right/full: the unmatched build rows, appended after the pairs
        n_unmatched = 0
        if how in ("right", "full"):
            nb = perm.shape[0]
            # lo holds SORTED positions here (fast_how is false); clamp against
            # the valid prefix as the general expansion does
            rhi = torch.minimum(lo + ln, jt.n_build_valid)
            rlo = torch.minimum(lo, jt.n_build_valid)
            cnt = torch.where(probe_kv, rhi - rlo, 0)
            # matched sorted-build positions via ±1 run marks + cumsum
            touch = cnt > 0
            marks = torch.zeros(nb + 1, dtype=torch.int32, device=dev)
            ones = torch.ones(np_, dtype=torch.int32, device=dev)
            marks.index_add_(0, torch.where(touch, rlo, nb).long(), ones)
            marks.index_add_(0, torch.where(touch, rhi, nb).long(), -ones)
            covered = torch.cumsum(marks[:nb], 0, dtype=torch.int32) > 0
            # existing-but-unmatched build rows, including null-key rows
            unmatched = jt.sorted_exists & ~covered
            upos, n_unmatched = _exclusive_cumsum(unmatched.to(torch.int32))

        # The identity expansion: unique build AND every probe row emits
        # exactly one output (referential-integrity joins, THE common PK-FK
        # case). Deciding it reads one flag from the device.
        matched = probe_kv & (ln > 0)
        if how == "left":
            fast_flag = uniq & probe_exists.all()
        elif fast_how:
            fast_flag = uniq & matched.all()
        else:
            fast_flag = None
        if fast_flag is not None:
            with tracing.sync("fast_flag"):
                fast_flag = bool(fast_flag)
        if fast_flag:
            C = np_ if capacity is None else capacity
            probe_out, build_out, total = _unique_expand(how, lo, matched, C)
        else:
            probe_out, build_out, total, C = _general_expand(
                how, lo, ln, probe_kv, probe_exists, perm, capacity,
                n_unmatched)

        if how in ("right", "full"):
            dst = total + upos
            uslot = torch.where(unmatched & (dst < C), dst, C)
            build_out = _scatter_back(build_out, uslot, perm)
            total = total + n_unmatched

        overflow = total > C
        if build_unique and fast_how:
            overflow = overflow | ~uniq
        count = total.clamp(max=C).to(torch.int32)
        return JoinResult(probe_out, build_out, count, overflow)


def _stack(items):
    """Stack a list of equal-structure results leaf by leaf."""
    first = items[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(items)
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        return type(first)(*[_stack(list(x)) for x in zip(*items)])
    if isinstance(first, (tuple, list)):
        return type(first)(_stack(list(x)) for x in zip(*items))
    if isinstance(first, dict):
        return {k: _stack([it[k] for it in items]) for k in first}
    return torch.as_tensor(items)


def join_stream(build_keys, num_chunks: int, chunk_fn=None,
                probe_stacked=None, capacity: int = None,
                how: str = "inner", consume=None,
                build_valid=None, build_exists=None,
                build_unique: bool = False):
    """Build-once/probe-many streaming join: BASELINE configs[3] at full
    1B×10M scale, where the probe side cannot be device-resident.

    The build side compiles into a JoinTable once; probe chunks stream
    through a Python loop on the device. Two probe sources:
      - ``probe_stacked``: a [K, n] tensor of K resident chunks (or a
        (keys, valid) tuple of them);
      - ``chunk_fn(i) -> keys`` or ``(keys, valid)``: chunk i (a Python
        int) made on the device, so a 1B-row probe runs without 8 GB of
        resident keys.
    ``consume(JoinResult) -> tensor, tuple or dict`` reduces each chunk's
    result (checksums, aggregates); by default the raw JoinResults are
    kept (K · capacity memory — use ``consume`` at scale).

    Returns a zero-argument callable giving (the outputs stacked leaf by
    leaf, any_overflow as a 0-d bool tensor). probe_idx values are LOCAL to
    each chunk (chunk i row j = global row i·n + j)."""
    how = how.lower()
    _check_how(how)
    if (chunk_fn is None) == (probe_stacked is None):
        raise ValueError("pass exactly one of chunk_fn / probe_stacked")
    if capacity is None:
        raise ValueError("capacity (per chunk) is required")
    if num_chunks < 1:
        raise ValueError(f"num_chunks must be at least 1, got {num_chunks}")

    def run():
        jt = build_join_table(build_keys, build_valid=build_valid,
                              build_exists=build_exists, how=how)
        outs, overflows = [], []
        for i in range(num_chunks):
            if probe_stacked is not None:
                chunk = tuple(a[i % num_chunks] for a in probe_stacked) \
                    if isinstance(probe_stacked, tuple) \
                    else probe_stacked[i % num_chunks]
            else:
                chunk = chunk_fn(i)
            keys, valid = chunk if isinstance(chunk, tuple) else (chunk,
                                                                  None)
            res = probe_chunk(jt, keys, capacity, how, probe_valid=valid,
                              build_unique=build_unique)
            outs.append(res if consume is None else consume(res))
            overflows.append(res.overflow)
        return _stack(outs), torch.stack(overflows).any()

    return run


def gather_payload(result: JoinResult, probe_cols=None, build_cols=None):
    """Materialize output columns from a JoinResult.

    Each cols dict maps name → (values, validity-or-None); unmatched side
    rows come out null. Returns ({name: (values, validity)}, row_valid)."""
    with tracing.span("gt.join.gather",
                      device=result.probe_idx.device):
        out = {}
        r = torch.arange(result.probe_idx.shape[0],
                         device=result.probe_idx.device)
        row_ok = r < result.count
        for cols, idx in ((probe_cols, result.probe_idx),
                          (build_cols, result.build_idx)):
            if not cols:
                continue
            present = (idx >= 0) & row_ok
            safe = idx.clamp(min=0).long()
            for name, (vals, validity) in cols.items():
                g = signed_view(vals).index_select(0, safe).view(vals.dtype)
                gv = present if validity is None \
                    else (validity.index_select(0, safe) & present)
                out[name] = (g, gv)
        return out, row_ok


def join_multi(probe_keys_list, build_keys_list, capacity: int,
               how: str = "inner", probe_valids=None, build_valids=None,
               probe_exists=None, build_exists=None) -> JoinResult:
    """Composite-key join: match on the first key column, then apply the
    remaining key equalities as a residual filter on the candidate pairs.

    Exact for all six join types: residual-failed pairs are recomputed per
    probe row (and, for right/full, per build row via scatter-or hit flags)
    so outer emission and semi/anti predicates see the composite-match
    truth. ``capacity`` bounds the *first-key* candidate pairs (the worst
    case), so pick it for the most selective column first.
    """
    how = how.lower()
    _check_how(how)
    k = len(probe_keys_list)
    if len(build_keys_list) != k or k < 1:
        raise ValueError("join_multi needs the same number (≥ 1) of probe "
                         "and build key columns")
    if probe_valids is None:
        probe_valids = [None] * k
    if build_valids is None:
        build_valids = [None] * k
    dev = probe_keys_list[0].device

    def all_kv(valids, n):
        out = None
        for v in valids:
            if v is None:
                continue
            out = v if out is None else (out & v)
        return out if out is not None else torch.ones(n, dtype=torch.bool,
                                                      device=dev)

    np_ = probe_keys_list[0].shape[0]
    nb = build_keys_list[0].shape[0]
    pkv = all_kv(probe_valids, np_)   # any null key ⇒ row never matches
    bkv = all_kv(build_valids, nb)

    # candidate pairs on the first key (inner — residual decides the rest)
    cand = join(probe_keys_list[0], build_keys_list[0], capacity, "inner",
                probe_valid=pkv, build_valid=bkv,
                probe_exists=probe_exists, build_exists=build_exists)
    C = cand.probe_idx.shape[0]
    pair_ok = torch.arange(C, device=dev) < cand.count
    pidx = cand.probe_idx.clamp(0, max(np_ - 1, 0)).long()
    bidx = cand.build_idx.clamp(0, max(nb - 1, 0)).long()
    match = pair_ok
    for i in range(1, k):
        pv = probe_keys_list[i].index_select(0, pidx)
        bv = build_keys_list[i].index_select(0, bidx)
        match = match & (pv == bv)

    if how == "inner":
        _, count, packed = compact_sort(match, [cand.probe_idx,
                                                cand.build_idx])
        return JoinResult(packed[0], packed[1], count, cand.overflow)

    # probe-level composite-match flags (scatter-or over candidate pairs)
    hit = torch.zeros(np_ + 1, dtype=torch.bool, device=dev).index_fill_(
        0, torch.where(match, pidx, np_), True)[:np_]
    exists = probe_exists if probe_exists is not None \
        else torch.ones(np_, dtype=torch.bool, device=dev)
    r2 = torch.arange(np_, device=dev)

    if how in ("right", "full"):
        _, mcount, (probe_out, build_out) = compact_sort(
            match, [cand.probe_idx, cand.build_idx])
        total = mcount.to(torch.int64)
        if how == "full":
            uidx, ucount, _ = compact_sort((~hit) & exists)
            slot = torch.where(r2 < ucount, r2 + total, C)
            probe_out = _scatter_back(probe_out, slot, uidx)
            build_out = _scatter_back(build_out, slot, -1)
            total = total + ucount
        # build-level composite-match flags → unmatched build rows
        bexists = build_exists if build_exists is not None \
            else torch.ones(nb, dtype=torch.bool, device=dev)
        bhit = torch.zeros(nb + 1, dtype=torch.bool, device=dev).index_fill_(
            0, torch.where(match, bidx, nb), True)[:nb]
        bids, bcount, _ = compact_sort((~bhit) & bexists)
        r3 = torch.arange(nb, device=dev)
        slot = torch.where(r3 < bcount, r3 + total, C)
        probe_out = _scatter_back(probe_out, slot, -1)
        build_out = _scatter_back(build_out, slot, bids)
        total = total + bcount
        return JoinResult(probe_out, build_out,
                          total.clamp(max=C).to(torch.int32),
                          cand.overflow | (total > C))
    if how in ("semi", "anti"):
        sel = (hit if how == "semi" else ~hit) & exists
        idx, count, _ = compact_sort(sel)
        return JoinResult(idx, _full(np_, -1, torch.int32, dev), count,
                          cand.overflow)
    # left: matched pairs + unmatched probe rows with null build
    _, mcount, (probe_out, build_out) = compact_sort(
        match, [cand.probe_idx, cand.build_idx])
    uidx, ucount, _ = compact_sort((~hit) & exists)
    # append unmatched rows after the matched pairs (uidx is probe-length)
    slot = torch.where(r2 < ucount, r2 + mcount, C)
    probe_out = _scatter_back(probe_out, slot, uidx)
    build_out = _scatter_back(build_out, slot, -1)
    total = mcount + ucount
    return JoinResult(probe_out, build_out, total.to(torch.int32),
                      cand.overflow | (total > C))


def _hash_probe_ranges(pk_norm, sorted_norm, n_valid, probe_kv,
                       perm=None, table_factor: int = 16):
    """_build_ranges_table then _probe_ranges, for direct callers.
    Returns (start, len, all_unique)."""
    table, all_unique = _build_ranges_table(sorted_norm, n_valid, perm,
                                            table_factor)
    start, ln = _probe_ranges(table, sorted_norm.shape[0], pk_norm,
                              probe_kv)
    if perm is None:
        all_unique = torch.zeros((), dtype=torch.bool,
                                 device=all_unique.device)
    return start, ln, all_unique


def _table_size(nb: int, table_factor: int) -> int:
    """Slots before the slack tail. Small builds widen the factor (higher
    factors cut chain incidence and length); each slot is 4 × int32 =
    16 B, so the factor halves until (T + nb slack) · 16 B fits
    _TABLE_BUDGET (1.5 GiB, the reference's choice for its device; an open
    question on the card's 80 GB, ROADMAP)."""
    if nb <= (1 << 21):
        table_factor = max(table_factor, 64)
    elif nb <= (1 << 22):
        table_factor = max(table_factor, 32)
    while table_factor > 4 and \
            (table_size_for(nb, table_factor) + nb) * 16 > _TABLE_BUDGET:
        table_factor //= 2
    return table_size_for(nb, table_factor)


def _build_ranges_table(sorted_norm, n_valid, perm=None,
                        table_factor: int = 16):
    """Build the duplicate-run hash table over the SORTED normalized build
    keys.

    Detect run starts in the sorted keys (duplicates are contiguous),
    compute run lengths via a suffix-min of start positions, then place one
    (key lo, key hi, start, len) entry per run into a LINEAR-probed table
    by a closed-form first-fit placement: sort the runs by home slot h_i
    (K4 and K3 on a card), then first-fit linear probing admits
    ``pos_i = i + cummax(h_i - i)``. Every pos is final and strictly
    increasing, written with one scatter.

    When ``perm`` is given (sorted order → original row), LENGTH-1 runs
    store the ORIGINAL build row in the start field instead of the sorted
    position; callers branch per row on len == 1, and on the returned
    ``all_unique`` flag to skip the run expansion entirely.

    ``n_valid`` is an int or a 0-d tensor. Returns (table int32
    [T + nb, 4], all_unique).

    CUDA tensors take the two kernels of ``kernels/join_build.py`` (run
    detection, then placement after the same sort of the home slots), and
    the counter ``kernel_rows`` of the open span says how many build rows
    they took; CPU tensors take the torch chain of _build_ranges_plain."""
    sk64 = _widen(sorted_norm)
    nb = sk64.shape[0]
    T = _table_size(nb, table_factor)
    if sk64.device.type == "cuda":
        tracing.add("kernel_rows", nb)
        return build_ranges_cuda(sk64, n_valid, perm, T)
    return _build_ranges_plain(sk64, n_valid, perm, T)


def _build_ranges_plain(sk64, n_valid, perm, T: int):
    """_build_ranges_table's torch chain over the sorted int64 keys
    ``sk64``, into ``T`` home slots: the plain version that the kernels of
    ``kernels/join_build.py`` equal bit for bit (on any device)."""
    nb = sk64.shape[0]
    dev = sk64.device
    # slack tail: worst-case first-fit overhang is < nb slots past the
    # last home slot
    T_tot = T + nb
    table = torch.zeros(T_tot + 1, 4, dtype=torch.int32, device=dev)
    if nb == 0:
        return table[:T_tot], _scalar(perm is not None, torch.bool, dev)
    iota = torch.arange(nb, dtype=torch.int32, device=dev)
    valid = iota < n_valid
    prev_ne = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                         sk64[1:] != sk64[:-1]])
    is_start = valid & prev_ne
    # strictly-next start position via a reversed cummin, shifted one left;
    # clamp to the valid prefix (a valid max-key run merges into the pinned
    # sentinel tail — the clamp cuts it back)
    start_pos = torch.where(is_start, iota, nb)
    nxt = torch.cummin(start_pos.flip(0), 0).values.flip(0)
    nxt = torch.cat([nxt[1:], _full(1, nb, torch.int32, dev)])
    # ≥ 1 at run starts
    run_len = (nxt.clamp(max=n_valid) - iota).to(torch.int32)

    all_unique = ~(is_start & (run_len > 1)).any()
    if perm is not None:
        start_field = torch.where(run_len == 1, perm.to(torch.int32), iota)
    else:
        start_field = iota
        all_unique = torch.zeros((), dtype=torch.bool, device=dev)

    lo, hi = _limbs(sk64)
    rows = torch.stack([lo, hi, start_field, run_len], 1)

    # ---- closed-form first-fit placement ----
    h_key = torch.where(is_start, hash32(sk64) % T, T_tot)  # non-starts last
    order = sort_permutation([SortKey(h_key)])
    hs = h_key.index_select(0, order)
    iota64 = iota.to(torch.int64)
    pos = iota64 + torch.cummax(hs - iota64, 0).values
    # non-starts inherit the sentinel (pos ≥ T_tot: the dump row), start
    # rows fit below T_tot (homes ≤ T - 1, overhang < nb ≤ slack)
    table[pos.clamp(max=T_tot)] = rows.index_select(0, order)
    return table[:T_tot], all_unique


def _probe_ranges(table, nb: int, pk_norm, probe_kv):
    """Each probe key's duplicate-run (start, len) against a table from
    _build_ranges_table, len 0 for absent and invalid keys: the one place
    that picks the probe's route.

    CUDA tensors take the kernel of ``kernels/join_probe.py``, one launch
    and no host sync for every probe size and skew, and the counter
    ``kernel_rows`` of the open span says how many probe rows it took; CPU
    tensors take the reference's chain, _probe_ranges_table."""
    if pk_norm.device.type == "cuda":
        tracing.add("kernel_rows", pk_norm.shape[0])
        return probe_ranges_cuda(_widen(pk_norm).contiguous(),
                                 probe_kv.contiguous(), table,
                                 table.shape[0] - nb)
    start, ln, _ = _probe_ranges_table(table, nb, pk_norm, probe_kv)
    return start, ln


def _probe_ranges_table(table, nb: int, pk_norm, probe_kv,
                        hot_k: int = 128, hot_min_rows: int = _HOT_MIN_ROWS):
    """Resolve each probe key to its duplicate-run (start, len) against a
    table from _build_ranges_table, by the reference's chain of array
    operations: the plain version of ``kernels/join_probe.py``, which the
    probe takes on CPU tensors (the card's probe is the kernel, see
    _probe_ranges) and ``probe_diagnostics`` on either.

    Two regimes: probes of at least ``hot_min_rows`` rows take the hot-key
    path (_probe_ranges_hot), which resolves a sampled top-``hot_k`` key set
    without the table and gathers only for the cold rest; smaller probes
    take the dense path (_probe_ranges_dense).

    Returns (start, len, diagnostics) — len 0 for absent/invalid keys."""
    np_ = pk_norm.shape[0]
    if hot_k > 0 and np_ >= max(hot_min_rows, 1):
        return _probe_ranges_hot(table, nb, pk_norm, probe_kv, hot_k)
    return _probe_ranges_dense(table, nb, pk_norm, probe_kv)


def probe_diagnostics(jt: JoinTable, probe_keys, probe_valid=None):
    """Residue and fallback counters for one probe chunk, as 0-d int32
    tensors, the same five on both paths of the reference's chain
    (_probe_ranges_table), which this runs on any device: ``hot_rows`` (0
    on the dense path), ``residue_rows`` against ``residue_capacity`` (the
    compacted tier), ``walk_rows`` (the rows the compacted chain walk took:
    on the dense path min(residue_rows, residue_capacity)) and
    ``fallback_rows`` (> 0 means a capacity overflowed and a full-width walk
    ran). They describe the reference's tiers: the card's probe
    (``probe_chunk`` on CUDA tensors) no longer takes them, its kernel walks
    every row's chain in one pass."""
    np_ = probe_keys.shape[0]
    if probe_valid is None:
        probe_valid = torch.ones(np_, dtype=torch.bool,
                                 device=probe_keys.device)
    _, _, diag = _probe_ranges_table(jt.table, jt.perm.shape[0],
                                     normalize_key(probe_keys), probe_valid)
    return diag


def _probe_ranges_dense(table, nb: int, pk_norm, probe_kv):
    """Dense probe: one full-width round-1 gather of the home slot, then the
    unresolved residue compacted (K2) and walked at 1/16 width, then a
    full-width walk that runs only if the residue overflowed its capacity.

    At slot load ≤ 1/16 almost every probe resolves in round 1 (home hit or
    home empty). An empty slot proves absence (linear probing); chains run
    un-wrapped into the nb-slot slack tail, so even an all-one-home build
    stays in bounds."""
    T_tot = table.shape[0]
    T = T_tot - nb
    np_ = pk_norm.shape[0]
    dev = pk_norm.device
    pk64 = _widen(pk_norm)
    plo, phi = _limbs(pk64)
    h0p = hash32(pk64) % T

    # ---- round 1: one full-width probe -----------------------------------
    got = table.index_select(0, torch.where(probe_kv, h0p, 0))
    occ = got[:, 3] > 0
    hit = occ & (got[:, 0] == plo) & (got[:, 1] == phi)
    take = probe_kv & hit
    start = torch.where(take, got[:, 2], 0)
    ln = torch.where(take, got[:, 3], 0)
    unresolved = probe_kv & occ & ~hit

    # ---- compacted continuation (K2) -------------------------------------
    # residue capacity: np/16 leaves a wide margin over the few percent
    # unresolved; overflow falls to the full-width walk below
    cap = min(np_, max(4096, np_ // 16))
    idx_un, n_un, _ = compact_fragnet(unresolved)
    sel = idx_un[:cap].clamp(0, max(np_ - 1, 0)).long()
    live = torch.arange(cap, device=dev) < n_un.clamp(max=cap)
    start_s, ln_s = _walk(table, h0p.index_select(0, sel) + 1,
                          plo.index_select(0, sel), phi.index_select(0, sel),
                          live, torch.zeros(cap, dtype=torch.int32,
                                            device=dev),
                          torch.zeros(cap, dtype=torch.int32, device=dev))
    # the walked rows were unresolved, so their round-1 start/len are 0
    tgt = torch.where(live, sel, np_)
    start = _scatter_back(start, tgt, start_s)
    ln = _scatter_back(ln, tgt, ln_s)
    covered = _scatter_back(torch.zeros(np_, dtype=torch.bool, device=dev),
                            tgt, live)

    # ---- overflow fallback (unresolved rows beyond cap): full-width walk,
    # zero rounds unless cap overflowed ----------------------------------
    unresolved2 = unresolved & ~covered
    start, ln = _walk(table, h0p + 1, plo, phi, unresolved2, start, ln)
    diag = {"hot_rows": _scalar(0, torch.int32, dev),
            "residue_rows": n_un,
            "residue_capacity": _scalar(cap, torch.int32, dev),
            "walk_rows": n_un.clamp(max=cap),
            "fallback_rows": unresolved2.sum(dtype=torch.int32)}
    return start, ln, diag


def _hot_resolve(table, nb: int, pk64, probe_kv, K: int):
    """Steps 1–3 of the hot-key probe: (is_hot, start, len) per probe row.

    1. A 64k strided sample is sorted; run lengths rank the keys; the top K
       by a stable sort of the negated counts (the reference's tie order)
       with a sample count ≥ 4 form the hot set. Correctness never depends
       on the choice: hot keys are verified by exact 64-bit equality, and
       every other row goes to the table.
    2. The hot keys resolve their (start, len) with one K-wide chain walk.
    3. Every probe row looks its key up among the sorted hot keys
       (``searchsorted`` and an equality check). The hot keys are distinct,
       so a row matches at most one; len + 1 tells "hot but absent from the
       build" (len 0, still spared the gather) from "not hot". Null rows are
       resolved too, as the reference resolves them; callers mask them."""
    T_tot = table.shape[0]
    T = T_tot - nb
    np_ = pk64.shape[0]
    dev = pk64.device

    # ---- 1. sampled hot-key detection -----------------------------------
    m = min(65536, np_)
    stride = np_ // m
    samp = torch.where(probe_kv[::stride][:m], pk64[::stride][:m], _I64_MAX)
    ss = torch.sort(samp).values
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                       ss[1:] != ss[:-1]])
    iota_s = torch.arange(m, device=dev)
    nxt = torch.cummin(torch.where(first, iota_s, m).flip(0), 0).values.flip(0)
    nxt = torch.cat([nxt[1:], _full(1, m, torch.int64, dev)])
    cnt_s = torch.where(first & (ss != _I64_MAX), nxt - iota_s, 0)
    topi = torch.sort(-cnt_s, stable=True).indices[:K]
    hot64 = ss.index_select(0, topi)
    hot_ok = (cnt_s.index_select(0, topi) >= 4) & (hot64 != _I64_MAX)

    # ---- 2. resolve the hot keys against the table (K-wide walk) --------
    k = hot64.shape[0]
    hlo, hhi = _limbs(hot64)
    zeros = torch.zeros(k, dtype=torch.int32, device=dev)
    h_start, h_len = _walk(table, hash32(hot64) % T, hlo, hhi, hot_ok, zeros,
                           zeros)
    h_lnp1 = torch.where(hot_ok, h_len + 1, 0)

    # ---- 3. full-width lookup among the sorted hot keys ------------------
    keys, order = torch.sort(torch.where(hot_ok, hot64, _I64_MAX))
    at = torch.searchsorted(keys, pk64).clamp(max=k - 1)
    lnp1 = h_lnp1.index_select(0, order).index_select(0, at)
    is_hot = (keys.index_select(0, at) == pk64) & (lnp1 > 0)
    start = torch.where(
        is_hot, h_start.index_select(0, order).index_select(0, at), 0)
    ln = torch.where(is_hot, lnp1 - 1, 0)
    return is_hot, start, ln


def _probe_ranges_hot(table, nb: int, pk_norm, probe_kv, K: int):
    """Hot-key probe: resolve the top-K sampled probe keys without touching
    the table (``_hot_resolve``), and only the cold rest through it.

    4. Cold rows compact (K2, the int64 key as their payload) to an np/4
       subset: a round-1 gather at quarter width; its unresolved rows
       compact again (K2, with their next slot) to a second tier walked
       along their chains; results scatter back to full width.
    5. Capacity overflows (cold > np/4 on low-skew data, or residue >
       tier-2 cap) fall to a full-width walk from the home slot, which runs
       (and pays its full-width ranks) only when an overflow happened.
    """
    T_tot = table.shape[0]
    T = T_tot - nb
    np_ = pk_norm.shape[0]
    dev = pk_norm.device
    pk64 = _widen(pk_norm)
    is_hot, start, ln = _hot_resolve(table, nb, pk64, probe_kv, K)

    # ---- 4. cold tier: compacted round-1 + second-tier chain walk -------
    cold = probe_kv & ~is_hot
    C1 = min(np_, max(8192, np_ // 4))
    idx1, n1, (pk_c,) = compact_fragnet(cold, [pk64])
    live1 = torch.arange(C1, device=dev) < n1.clamp(max=C1)
    sel1 = idx1[:C1].clamp(0, np_ - 1).long()
    pk_s = pk_c[:C1]
    plo_s, phi_s = _limbs(pk_s)
    h0p_s = hash32(pk_s) % T
    got = table.index_select(0, torch.where(live1, h0p_s, 0))
    occ = got[:, 3] > 0
    hit = occ & (got[:, 0] == plo_s) & (got[:, 1] == phi_s)
    take = live1 & hit
    start_s = torch.where(take, got[:, 2], 0)
    ln_s = torch.where(take, got[:, 3], 0)
    unres_s = live1 & occ & ~hit

    C2 = min(C1, max(4096, C1 // 8))
    idx2, n2, (pos_c, pk_c2) = compact_fragnet(unres_s, [h0p_s + 1, pk_s])
    live2 = torch.arange(C2, device=dev) < n2.clamp(max=C2)
    sel2 = idx2[:C2].clamp(0, C1 - 1).long()
    plo_w, phi_w = _limbs(pk_c2[:C2])
    zeros = torch.zeros(C2, dtype=torch.int32, device=dev)
    st_w, ln_w = _walk(table, pos_c[:C2], plo_w, phi_w, live2, zeros, zeros)
    # the walked rows were unresolved in round 1, so their start/len are 0
    tgt2 = torch.where(live2, sel2, C1)
    start_s = _scatter_back(start_s, tgt2, st_w)
    ln_s = _scatter_back(ln_s, tgt2, ln_w)

    # cold rows are not hot, so their start/len are 0 before the scatter
    tgt1 = torch.where(live1, sel1, np_)
    start = _scatter_back(start, tgt1, start_s)
    ln = _scatter_back(ln, tgt1, ln_s)

    # ---- 5. overflow fallback: full-width walk from home ----------------
    with tracing.sync("probe_capacity"):
        overflowed = bool((n1 > C1) | (n2 > C2))
    if overflowed:
        rank1 = torch.cumsum(cold, 0, dtype=torch.int32)
        rank2 = torch.cumsum(unres_s, 0, dtype=torch.int32)
        unres_full = (cold & (rank1 > C1)) | _scatter_back(
            torch.zeros(np_, dtype=torch.bool, device=dev), tgt1,
            unres_s & (rank2 > C2))
        plo, phi = _limbs(pk64)
        start, ln = _walk(table, hash32(pk64) % T, plo, phi, unres_full,
                          start, ln)
        fallback = unres_full.sum(dtype=torch.int32)
    else:
        fallback = _scalar(0, torch.int32, dev)
    diag = {"hot_rows": is_hot.sum(dtype=torch.int32),
            "residue_rows": n1,
            "residue_capacity": _scalar(C1, torch.int32, dev),
            "walk_rows": n2,
            "fallback_rows": fallback}
    return start, ln, diag


def _as_i64(keys: torch.Tensor) -> torch.Tensor:
    """The reference's ``astype(int64)``: floats truncate, integers widen."""
    return keys.to(torch.int64) if keys.is_floating_point() else widen(keys)


def _hash_probe_unique(probe_keys, build_keys, probe_kv, build_kv):
    """Hash-table probe for UNIQUE build keys: returns (matched, build_idx,
    duplicate flag) per probe row. Double hashing (odd stride) over a table
    of (key lo, key hi, build row, occupied) int32 rows; claim-and-reread
    rounds build it, one sync per round; in a round, the highest row id
    among a slot's claimants takes it, as a serial scatter would. Duplicate
    build keys are detected and reported (the row that took the key's slot
    answers for it), and callers treat them like a capacity overflow. Kept
    for direct callers: ``probe_chunk`` detects a unique build on its
    general path."""
    nb = build_keys.shape[0]
    np_ = probe_keys.shape[0]
    dev = build_keys.device
    T = table_size_for(nb, 4)

    bk64 = _as_i64(build_keys)
    blo, bhi = _limbs(bk64)
    pos = hash32(bk64) % T
    step = (hash32(bk64, 0x9E37) % T) | 1
    table = torch.zeros(T + 1, 4, dtype=torch.int32, device=dev)
    row_id = torch.arange(nb, device=dev)
    rows = torch.stack([blo, bhi, row_id.to(torch.int32),
                        torch.ones(nb, dtype=torch.int32, device=dev)], 1)
    unresolved = build_kv.clone()
    for _ in range(T):
        with tracing.sync("unique_build"):
            pending = bool(unresolved.any())
        if not pending:
            break
        slot = torch.where(unresolved, pos, T)
        claim = unresolved & ~(table.index_select(0, slot)[:, 3] > 0)
        # one winner per claimed slot, the last row as a serial scatter
        # leaves it: a row put with repeated indices may tear on the card
        cslot = torch.where(claim, slot, T)
        owner = _full(T + 1, -1, torch.int64, dev).scatter_reduce_(
            0, cslot, row_id, "amax")
        win = claim & (owner.index_select(0, cslot) == row_id)
        # losers land in the dump row T, which no live row reads
        table[torch.where(win, slot, T)] = rows
        got = table.index_select(0, slot)
        settled = unresolved & (got[:, 3] > 0) & (got[:, 0] == blo) \
            & (got[:, 1] == bhi)
        pos = (pos + step) % T
        unresolved = unresolved & ~settled
    n_filled = (table[:T, 3] > 0).sum(dtype=torch.int32)
    dup = n_filled < build_kv.sum(dtype=torch.int32)

    pk64 = _as_i64(probe_keys)
    plo, phi = _limbs(pk64)
    pos = hash32(pk64) % T
    step = (hash32(pk64, 0x9E37) % T) | 1
    matched = torch.zeros(np_, dtype=torch.bool, device=dev)
    bidx = _full(np_, -1, torch.int32, dev)
    unresolved = probe_kv.clone()
    for _ in range(T):
        with tracing.sync("unique_probe"):
            pending = bool(unresolved.any())
        if not pending:
            break
        got = table.index_select(0, torch.where(unresolved, pos, T))
        occ = got[:, 3] > 0
        hit = occ & (got[:, 0] == plo) & (got[:, 1] == phi)
        take = unresolved & hit
        matched = matched | take
        bidx = torch.where(take, got[:, 2], bidx)
        # resolved if hit or slot empty (key absent)
        unresolved = unresolved & occ & ~hit
        pos = (pos + step) % T
    return matched, bidx, dup
