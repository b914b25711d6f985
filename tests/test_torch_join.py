"""The port's hash join (slice E) against gandiva_tpu.ops.hash_join on the
CPU, on the same inputs made with numpy from a seed.

The port's CPU tensors take the plain versions of its kernels: K2's for the
residue compactions, K4's and K3's for the build-side sorts. The reference
runs eagerly on its CPU paths (``compact_sort``, ``lax.sort``). Integer
outputs are compared bit for bit: the tables, ``probe_idx`` / ``build_idx``
on ``[:count]``, ``count``, ``overflow`` and the diagnostics (the port's
dense path adds ``hot_rows`` = 0 and ``walk_rows`` = min(residue_rows,
residue_capacity), ROADMAP §3 item 4). The reference's ``join_stream`` and
its large-contention join tests run under ``jax.jit``, which the eager port
has no use for, so the port's streams are held against its own and the
reference's per-chunk joins, and the contention cases against numpy.
"""
import numpy as np
import pyarrow as pa
import pytest
import torch

import jax.numpy as jnp

from gandiva_tpu.ops import hash_join as j_hj
from gandiva_tpu.ops import sort as j_sort
from gandiva_tpu_torch.ops import hash_join as t_hj
from gandiva_tpu_torch.ops import sort as t_sort
from gandiva_tpu_torch.ops.kernels import LAUNCHES, reset_launches

HOWS = ["inner", "left", "right", "full", "semi", "anti"]
NP, NB = 2000, 300


def _t(x):
    return None if x is None else torch.from_numpy(np.ascontiguousarray(x))


def _j(x):
    return None if x is None else jnp.asarray(x)


def _same(ref, port):
    """Two JoinResults, bit for bit on [:count]."""
    c = int(ref.count)
    assert int(port.count) == c
    assert port.count.dtype == torch.int32
    assert bool(port.overflow) == bool(ref.overflow)
    assert port.probe_idx.dtype == port.build_idx.dtype == torch.int32
    assert port.probe_idx.shape[0] == np.asarray(ref.probe_idx).shape[0]
    np.testing.assert_array_equal(port.probe_idx.numpy()[:c],
                                  np.asarray(ref.probe_idx)[:c])
    np.testing.assert_array_equal(port.build_idx.numpy()[:c],
                                  np.asarray(ref.build_idx)[:c])


def _same_table(ref, port):
    np.testing.assert_array_equal(port.table.numpy(), np.asarray(ref.table))
    np.testing.assert_array_equal(port.perm.numpy(), np.asarray(ref.perm))
    np.testing.assert_array_equal(port.sorted_exists.numpy(),
                                  np.asarray(ref.sorted_exists))
    assert int(port.n_build_valid) == int(ref.n_build_valid)
    assert bool(port.all_unique) == bool(ref.all_unique)
    assert port.table.dtype == torch.int32 and port.table.shape[1] == 4


def _build_case(case, rng):
    """Build keys with duplicate runs and null keys, a build shorter than
    its buffer, or a run of int64::max beside the null rows that the table
    pins to the same norm."""
    build = rng.integers(0, 500, NB)
    valid = rng.random(NB) >= 0.1
    length = None
    if case == "n_valid_lt_nb":
        length = NB - 37
    elif case == "int64_max":
        build[rng.random(NB) < 0.1] = np.iinfo(np.int64).max
        build[rng.random(NB) < 0.05] = np.iinfo(np.int64).min
    return build, valid, length


@pytest.mark.parametrize("how", ["inner", "right"])
@pytest.mark.parametrize("case", ["dups_nulls", "n_valid_lt_nb", "int64_max"])
def test_build_join_table_matches_reference(case, how):
    """The table with ``perm`` (inner: length-1 runs hold original rows)
    and without (right: sorted positions), and every JoinTable field."""
    rng = np.random.default_rng(len(case))
    build, valid, length = _build_case(case, rng)
    ref = j_hj.build_join_table(_j(build), build_valid=_j(valid),
                                build_length=length, how=how)
    port = t_hj.build_join_table(_t(build), build_valid=_t(valid),
                                 build_length=length, how=how)
    _same_table(ref, port)


@pytest.mark.parametrize("how", ["inner", "right"])
def test_cpu_build_never_loads_the_join_build_kernels(monkeypatch, how):
    """CPU tensors take the plain torch chain: the build loads no kernel
    library (csrc/join_build.cu least of all), its table is the
    reference's, and its span counts no ``kernel_rows`` (the kernels took
    no row)."""
    from torch.profiler import ProfilerActivity, profile

    from gandiva_tpu_torch import tracing
    from gandiva_tpu_torch.ops.kernels import build, join_build

    def refuse(*_args, **_kwargs):
        raise AssertionError("a build on CPU tensors loaded a kernel library")

    monkeypatch.setattr(join_build, "library", refuse)
    monkeypatch.setattr(build, "load", refuse)
    rng = np.random.default_rng(17)
    keys, valid, _ = _build_case("dups_nulls", rng)
    tracing.clear()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            port = t_hj.build_join_table(_t(keys), build_valid=_t(valid),
                                         how=how)
        spans = [s for s in tracing.spans() if s.name == "gt.join.build"]
    finally:
        tracing.clear()
    assert [s.counters for s in spans] == [{}]
    _same_table(j_hj.build_join_table(_j(keys), build_valid=_j(valid),
                                      how=how), port)


@pytest.mark.parametrize("with_perm", [False, True])
@pytest.mark.parametrize("unique", [False, True])
def test_build_ranges_table_matches_reference(with_perm, unique):
    """``_build_ranges_table`` on the same sorted norms, n_valid < nb."""
    rng = np.random.default_rng(3)
    keys = rng.permutation(5000)[:NB] if unique else rng.integers(0, 200, NB)
    norm = np.sort(keys.astype(np.uint64) ^ np.uint64(1 << 63))
    perm = rng.permutation(NB).astype(np.int32)
    n_valid = NB - 11
    ref_t, ref_u = j_hj._build_ranges_table(
        jnp.asarray(norm), jnp.int32(n_valid),
        jnp.asarray(perm) if with_perm else None)
    t, u = t_hj._build_ranges_table(_t(norm.view(np.int64)), n_valid,
                                    _t(perm) if with_perm else None)
    np.testing.assert_array_equal(t.numpy(), np.asarray(ref_t))
    assert bool(u) == bool(ref_u) == (unique and with_perm)


def _hot_probe(dist, rng, n):
    if dist == "zipf":
        return (rng.zipf(1.3, n) % 3500).astype(np.int64)
    if dist == "uniform":         # ~no hot keys: the cold tier overflows
        return rng.integers(0, 3500, n)
    return np.full(n, 7, dtype=np.int64)


@pytest.mark.parametrize("dist", ["zipf", "uniform", "allsame"])
def test_probe_ranges_dense_and_hot_match_reference(dist):
    """Both probe tiers at 65,536 × 4,096 rows: the port's hot path equals
    its dense path, and each equals the reference's, diagnostics included."""
    rng = np.random.default_rng(23)
    nb, n = 4096, 65536
    build = rng.integers(0, 3000, nb)
    probe = _hot_probe(dist, rng, n)
    pkv = rng.random(n) >= 0.05
    kv = jnp.ones((nb,), bool)
    perm, (sk,), _ = j_sort._sort_full(
        [j_sort.SortKey(jnp.asarray(build), validity=kv, nulls_first=False)],
        None)
    table, _ = j_hj._build_ranges_table(sk, jnp.int32(nb), perm)
    pk = j_sort.normalize_key(jnp.asarray(probe))
    ref_dense = j_hj._probe_ranges_dense(table, nb, pk, jnp.asarray(pkv))
    ref_hot = j_hj._probe_ranges_hot(table, nb, pk, jnp.asarray(pkv), 128)

    tperm, (tsk,) = t_sort._sort_full(
        [t_sort.SortKey(_t(build), validity=torch.ones(nb, dtype=torch.bool),
                        nulls_first=False)], None)
    ttable, _ = t_hj._build_ranges_table(tsk, nb, tperm)
    np.testing.assert_array_equal(ttable.numpy(), np.asarray(table))
    tpk = t_sort.normalize_key(_t(probe))
    dense = t_hj._probe_ranges_dense(ttable, nb, tpk, _t(pkv))
    hot = t_hj._probe_ranges_hot(ttable, nb, tpk, _t(pkv), 128)

    valid = pkv   # the hot path resolves null rows too; callers mask them
    for (s, ln, _), (rs, rln, _) in ((dense, ref_dense), (hot, ref_hot)):
        np.testing.assert_array_equal(s.numpy(), np.asarray(rs))
        np.testing.assert_array_equal(ln.numpy(), np.asarray(rln))
    np.testing.assert_array_equal(hot[0].numpy()[valid],
                                  dense[0].numpy()[valid])
    np.testing.assert_array_equal(hot[1].numpy()[valid],
                                  dense[1].numpy()[valid])
    assert int(dense[1].sum()) > 0
    rd, d = ref_dense[2], dense[2]
    assert {k: int(v) for k, v in d.items()} == {
        **{k: int(v) for k, v in rd.items()}, "hot_rows": 0,
        "walk_rows": min(int(rd["residue_rows"]),
                         int(rd["residue_capacity"]))}
    assert {k: int(v) for k, v in hot[2].items()} == {
        k: int(v) for k, v in ref_hot[2].items()}
    assert set(d) == set(hot[2])
    if dist == "uniform":
        assert int(hot[2]["fallback_rows"]) > 0


def _join_case(case, rng):
    """(probe, build, capacity, kwargs for both joins)."""
    probe = rng.integers(0, 500, NP)
    build = rng.integers(0, 700, NB)
    kw = {}
    cap = 8192
    if case == "dups_nulls":
        kw = dict(probe_valid=rng.random(NP) >= 0.1,
                  build_valid=rng.random(NB) >= 0.1)
    elif case == "exists_length":
        kw = dict(probe_valid=rng.random(NP) >= 0.1,
                  probe_exists=rng.random(NP) >= 0.2,
                  build_exists=rng.random(NB) >= 0.2,
                  probe_length=NP - 101, build_length=NB - 17)
    elif case == "unique_all_match":      # the identity expansion
        build = rng.permutation(NB)
        probe = rng.integers(0, NB, NP)
        cap = NP
    elif case == "unique_partial":
        build = rng.permutation(800)[:NB]
        probe = rng.integers(0, 800, NP)
    elif case == "overflow":
        cap = 256
    elif case == "build_unique_dups":
        kw = dict(build_unique=True)
    return probe, build, cap, kw


@pytest.mark.parametrize("how", HOWS)
@pytest.mark.parametrize("case", ["dups_nulls", "exists_length",
                                  "unique_all_match", "unique_partial",
                                  "overflow", "build_unique_dups"])
def test_join_matches_reference(case, how):
    rng = np.random.default_rng(len(case) * 7 + len(how))
    probe, build, cap, kw = _join_case(case, rng)
    ref = j_hj.join(_j(probe), _j(build), cap, how,
                    **{k: _j(v) if isinstance(v, np.ndarray) else v
                       for k, v in kw.items()})
    reset_launches()
    port = t_hj.join(_t(probe), _t(build), cap, how,
                     **{k: _t(v) if isinstance(v, np.ndarray) else v
                        for k, v in kw.items()})
    assert not any(LAUNCHES.values())      # CPU tensors: plain versions
    _same(ref, port)
    if case == "overflow":
        assert bool(port.overflow)
    if case == "build_unique_dups" and how in ("inner", "left", "semi",
                                               "anti"):
        assert bool(port.overflow)


@pytest.mark.parametrize("how", HOWS)
@pytest.mark.parametrize("nkeys", [2, 3])
def test_join_multi_matches_reference(how, nkeys):
    rng = np.random.default_rng(9 + nkeys)
    pks = [rng.integers(0, 100, NP)] + [rng.integers(0, 4, NP)
                                        for _ in range(nkeys - 1)]
    bks = [rng.integers(0, 120, NB)] + [rng.integers(0, 4, NB)
                                        for _ in range(nkeys - 1)]
    pv = [rng.random(NP) >= 0.05 for _ in range(nkeys)]
    bv = [rng.random(NB) >= 0.05 for _ in range(nkeys)]
    ref = j_hj.join_multi([_j(k) for k in pks], [_j(k) for k in bks], 8192,
                          how, probe_valids=[_j(v) for v in pv],
                          build_valids=[_j(v) for v in bv])
    port = t_hj.join_multi([_t(k) for k in pks], [_t(k) for k in bks], 8192,
                           how, probe_valids=[_t(v) for v in pv],
                           build_valids=[_t(v) for v in bv])
    _same(ref, port)


def _checksum(res):
    return (res.count.to(torch.int64)
            + res.build_idx.to(torch.int64).sum())


@pytest.mark.parametrize("consume", [False, True])
@pytest.mark.parametrize("source", ["probe_stacked", "chunk_fn"])
def test_join_stream_matches_per_chunk_and_monolithic(source, consume):
    """Each chunk of the stream equals the port's and the reference's join
    of that chunk alone, and all of them together give the monolithic
    join's pairs (probe indices are chunk-local)."""
    rng = np.random.default_rng(17)
    K, n = 3, NP
    build = rng.integers(0, 500, NB)
    chunks = rng.integers(0, 700, (K, n))
    valid = rng.random((K, n)) >= 0.05
    kw = dict(capacity=4 * n, how="inner",
              consume=_checksum if consume else None)
    if source == "probe_stacked":
        run = t_hj.join_stream(_t(build), K,
                               probe_stacked=(_t(chunks), _t(valid)), **kw)
    else:
        run = t_hj.join_stream(
            _t(build), K, chunk_fn=lambda i: (_t(chunks[i]), _t(valid[i])),
            **kw)
    outs, any_overflow = run()
    assert any_overflow.dtype == torch.bool and any_overflow.dim() == 0
    assert not bool(any_overflow)
    got = []
    for i in range(K):
        ref = j_hj.join(_j(chunks[i]), _j(build), 4 * n, "inner",
                        probe_valid=_j(valid[i]))
        port = t_hj.join(_t(chunks[i]), _t(build), 4 * n, "inner",
                         probe_valid=_t(valid[i]))
        _same(ref, port)
        if consume:
            assert int(outs[i]) == int(_checksum(port))
            continue
        res = t_hj.JoinResult(*(f[i] for f in outs))
        _same(ref, res)
        c = int(res.count)
        got += [(i * n + int(p), int(b)) for p, b in
                zip(res.probe_idx[:c], res.build_idx[:c])]
    if not consume:
        mono = t_hj.join(_t(chunks.reshape(-1)), _t(build), 4 * K * n,
                         "inner", probe_valid=_t(valid.reshape(-1)))
        c = int(mono.count)
        assert sorted(got) == sorted(zip(mono.probe_idx[:c].tolist(),
                                         mono.build_idx[:c].tolist()))


def test_join_stream_unique_build_checksum():
    """The configs[3] shape in small: a unique arange build, every probe key
    in it, checksum = n + Σ build_idx = n + Σ keys."""
    nb, K, n = 512, 3, 1024
    rng = np.random.default_rng(9)
    chunks = rng.integers(0, nb, (K, n))

    def consume(res):
        return (res.count.to(torch.int64)
                + res.probe_idx.to(torch.int64).sum()
                + res.build_idx.to(torch.int64).sum())

    outs, ovf = t_hj.join_stream(
        torch.arange(nb), K, chunk_fn=lambda i: _t(chunks[i]), capacity=n,
        how="inner", consume=consume, build_unique=True)()
    assert not bool(ovf)
    for i in range(K):
        assert int(outs[i]) == n + n * (n - 1) // 2 + int(chunks[i].sum())


def test_gather_payload_matches_reference():
    rng = np.random.default_rng(5)
    probe = rng.integers(0, 500, NP)
    build = rng.integers(0, 700, NB)
    pv, pvalid = rng.random(NP), rng.random(NP) >= 0.2
    bv = rng.integers(-10**12, 10**12, NB)
    bvalid = rng.random(NB) >= 0.2
    out = {}
    for mod, conv in ((j_hj, _j), (t_hj, _t)):
        res = mod.join(conv(probe), conv(build), 8192, "full")
        cols, row_ok = mod.gather_payload(
            res, probe_cols={"pv": (conv(pv), conv(pvalid))},
            build_cols={"bv": (conv(bv), conv(bvalid)),
                        "bw": (conv(bv * 2), None)})
        out[mod] = ({k: (np.asarray(v), np.asarray(m))
                     for k, (v, m) in cols.items()}, np.asarray(row_ok))
    (rcols, rok), (pcols, pok) = out[j_hj], out[t_hj]
    np.testing.assert_array_equal(pok, rok)
    assert set(pcols) == set(rcols) == {"pv", "bv", "bw"}
    for k in rcols:
        np.testing.assert_array_equal(pcols[k][1], rcols[k][1])
        live = rcols[k][1]
        assert live.any() and not live.all()
        np.testing.assert_array_equal(pcols[k][0][live], rcols[k][0][live])


@pytest.mark.parametrize("with_valid", [False, True])
def test_probe_diagnostics_matches_reference(with_valid):
    rng = np.random.default_rng(31)
    build = rng.integers(0, 1 << 40, NB)
    probe = np.where(rng.random(NP) < 0.5, build[rng.integers(0, NB, NP)],
                     rng.integers(0, 1 << 40, NP))
    valid = rng.random(NP) >= 0.1 if with_valid else None
    ref = j_hj.probe_diagnostics(j_hj.build_join_table(_j(build)),
                                 _j(probe), _j(valid))
    port = t_hj.probe_diagnostics(t_hj.build_join_table(_t(build)),
                                  _t(probe), _t(valid))
    ref = {k: int(v) for k, v in ref.items()}
    assert {k: int(v) for k, v in port.items()} == {
        **ref, "hot_rows": 0,
        "walk_rows": min(ref["residue_rows"], ref["residue_capacity"])}
    assert all(v.dtype == torch.int32 for v in port.values())
    assert ref["residue_rows"] > 0


def test_hash_probe_unique_dup_flag():
    """The port's form of test_large_contention's: a duplicate build key
    sets the flag; on a unique build the matches equal the reference's;
    join(build_unique=True) surfaces duplicates through ``overflow``."""
    probe = np.arange(1024)
    build_ok = np.arange(512) * 2
    build_dup = build_ok.copy()
    build_dup[17] = 44       # 44 appears twice (22*2 and slot 17)
    pkv, kv = np.ones(1024, bool), np.ones(512, bool)
    m, b, dup = t_hj._hash_probe_unique(_t(probe), _t(build_ok), _t(pkv),
                                        _t(kv))
    rm, rb, rdup = j_hj._hash_probe_unique(_j(probe), _j(build_ok),
                                           _j(pkv), _j(kv))
    assert not bool(dup) and not bool(rdup)
    np.testing.assert_array_equal(m.numpy(), np.asarray(rm))
    np.testing.assert_array_equal(b.numpy(), np.asarray(rb))
    m, b, dup = t_hj._hash_probe_unique(_t(probe), _t(build_dup), _t(pkv),
                                        _t(kv))
    rm, rb, _ = j_hj._hash_probe_unique(_j(probe), _j(build_dup), _j(pkv),
                                        _j(kv))
    assert bool(dup)
    # the last claimant of a slot wins, as the reference's serial scatter
    np.testing.assert_array_equal(m.numpy(), np.asarray(rm))
    np.testing.assert_array_equal(b.numpy(), np.asarray(rb))
    res = t_hj.join(_t(probe), _t(build_dup), 2048, "inner",
                    build_unique=True)
    assert bool(res.overflow)


def test_join_dup_keys_vs_numpy():
    """The port's form of test_large_contention's 1M × 256k case, at
    2^18 × 2^16 with ~4× duplicate build keys: every (probe, build) pair
    exact against a numpy oracle."""
    rng = np.random.default_rng(42)
    n, nb = 1 << 18, 1 << 16
    probe = rng.integers(0, nb // 4, n)
    build = rng.integers(0, nb // 4, nb)
    pc = np.bincount(probe, minlength=nb // 4)
    bc = np.bincount(build, minlength=nb // 4)
    total = int((pc * bc).sum())
    res = t_hj.join(_t(probe), _t(build), total + 64, "inner")
    assert not bool(res.overflow)
    c = int(res.count)
    assert c == total
    pi = res.probe_idx[:c].numpy().astype(np.int64)
    bi = res.build_idx[:c].numpy().astype(np.int64)
    assert (probe[pi] == build[bi]).all()
    assert np.unique(pi * nb + bi).size == c


@pytest.mark.parametrize("how", HOWS)
def test_join_matches_arrow(how):
    """Against pyarrow.acero's hashjoin, after sorting the pairs."""
    rng = np.random.default_rng(77)
    probe = rng.integers(0, 120, 700)
    build = rng.integers(0, 150, 200)
    pn, bn = rng.random(700) < 0.1, rng.random(200) < 0.1
    res = t_hj.join(_t(probe), _t(build), 8192, how, probe_valid=_t(~pn),
                    build_valid=_t(~bn))
    c = int(res.count)
    got = sorted(zip(res.probe_idx[:c].tolist(), res.build_idx[:c].tolist()))
    pt = pa.table({"k": pa.array(probe, mask=pn), "pv": np.arange(700)})
    bt = pa.table({"k": pa.array(build, mask=bn), "bv": np.arange(200)})
    acero = {"inner": "inner", "left": "left outer", "right": "right outer",
             "full": "full outer", "semi": "left semi", "anti": "left anti"}
    rows = pt.join(bt, keys="k", join_type=acero[how],
                   coalesce_keys=False).to_pylist()
    want = sorted((r["pv"] if r["pv"] is not None else -1,
                   r.get("bv") if r.get("bv") is not None else -1)
                  for r in rows)
    if how in ("semi", "anti"):
        got = sorted(p for p, _ in got)
        want = sorted(p for p, _ in want)
    assert got == want


def test_join_rejects_what_it_does_not_take():
    with pytest.raises(ValueError, match="join type"):
        t_hj.join(torch.zeros(4, dtype=torch.int64),
                  torch.zeros(4, dtype=torch.int64), 8, "cross")
    with pytest.raises(ValueError, match="2\\^31"):
        t_hj.probe_chunk(t_hj.build_join_table(torch.arange(4)),
                         torch.zeros(1, dtype=torch.int64).expand(1 << 31),
                         8)
    with pytest.raises(ValueError, match="exactly one"):
        t_hj.join_stream(torch.arange(4), 2, capacity=8)
