"""The port's date/time and interval registry (registry/datetime_ops.py)
against gandiva_tpu's on the same columns: every signature the port
registers there, each alias name included, one case each, bit for bit
(months_between's float64 too). Dates span 1600-01-01 to 2400-12-31, so
pre-epoch days and the Gregorian 100/400 rules are in every case. The
string-typed ones (to_date, is_date, castDATE/castTIMESTAMP of utf8,
next_day) parse a dictionary of date texts, valid and not, with their
format or weekday a literal."""
import datetime as pydt
import zlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import gandiva_tpu_torch as gt
from gandiva_tpu.registry import datetime_ops as g_dt
from gandiva_tpu_torch.registry import datetime_ops as t_dt
from gandiva_tpu_torch.registry.registry import global_registry

from torch_differential import (DAY_MAX, DAY_MIN, batches, column,
                                dtype_of, project_both, text_column)

N = 1000


def _datetime_signatures(p, module: str):
    """(name, param type names, return type name) of every signature of
    package ``p``, aliases included, whose function is ``module``'s."""
    reg = p.global_registry()
    out = set()
    for s in p.get_registered_function_signatures():
        fn = reg.lookup(s.name, s.param_types)
        if fn.impl.__module__ == module:
            out.add((s.name, tuple(map(str, s.param_types)),
                     str(s.return_type)))
    return sorted(out)


SIGNATURES = _datetime_signatures(gt, t_dt.__name__)


def test_signatures_are_the_reference_ones_without_strings():
    """The reference's date/time signatures, the nine that name a string
    (to_date ×2, is_date ×2, castDATE(utf8), castTIMESTAMP(utf8),
    next_day ×3) included."""
    import gandiva_tpu as g

    assert SIGNATURES == _datetime_signatures(g, g_dt.__name__)
    assert len(SIGNATURES) == 199 + 9
    assert sum("string" in s[1] for s in SIGNATURES) == 9


# dates and timestamps as text, in and out of the formats, multi-byte and
# padded among them
DATE_TEXTS = ["2020-03-01", "1969-12-31", "1600-01-01", "2400-12-31",
              "2020-02-30", "not a date", "", " 2021-07-04 ", "2020-03-01 "
              "12:30:45", "1999-12-31 23:59:59", "2020-3-1", "１９９９-01-01",
              "2000-02-29", "2100-02-29", "0001-01-01", "12/31/1999"]
FORMATS = {"to_date": "YYYY-MM-DD", "is_date": "YYYY-MM-DD",
           "next_day": "tuesday"}


@pytest.mark.parametrize("sig", SIGNATURES,
                         ids=[f"{n}({','.join(p)})" for n, p, _ in
                              SIGNATURES])
def test_signature_matches_reference(sig):
    name, params, ret = sig
    rng = np.random.default_rng(zlib.crc32(repr(sig).encode()))
    # the first string is a column of date texts, a later one the literal
    # format or weekday
    texts = [i for i, t in enumerate(params) if t == "string"]
    literal = texts[1:] if name != "next_day" else texts
    cols = {f"a{i}": (t, *(text_column(t, rng, N, DATE_TEXTS)
                           if t == "string" else
                           column(t, rng, N, kind="amount")))
            for i, t in enumerate(params) if i not in literal}

    def exprs(p, schema):
        B = p.TreeExprBuilder
        args = [B.make_string_literal(FORMATS[name]) if i in literal
                else B.make_field(schema.field(f"a{i}"))
                for i in range(len(params))]
        node = B.make_function(name, args, dtype_of(p, ret))
        return [B.make_expression(node, p.dtypes.Field("out",
                                                       node.dtype))]

    project_both(exprs, cols, N)


def test_civil_calendar_every_day_1600_to_2400():
    """days ↔ (y, m, d) over every day of the range against Python's
    proleptic Gregorian calendar and the reference's functions."""
    days = np.arange(DAY_MIN, DAY_MAX + 1, dtype=np.int64)
    y, m, d = (x.numpy() for x in t_dt.civil_from_days(torch.from_numpy(days)))
    epoch = pydt.date(1970, 1, 1).toordinal()
    for k in (0, 1, 59, 60, 36524, 146096, len(days) - 1):
        want = pydt.date.fromordinal(epoch + int(days[k]))
        assert (y[k], m[k], d[k]) == (want.year, want.month, want.day)
    ry, rm, rd = (np.asarray(x) for x in g_dt.civil_from_days(
        jnp.asarray(days)))
    np.testing.assert_array_equal(y, ry)
    np.testing.assert_array_equal(m, rm)
    np.testing.assert_array_equal(d, rd)
    back = t_dt.days_from_civil(*(torch.from_numpy(x) for x in (y, m, d)))
    np.testing.assert_array_equal(back.numpy(), days)
    for yy in (1600, 1700, 1900, 2000, 2100, 2400):
        leap = t_dt.is_leap(torch.tensor(yy)).item()
        assert leap == (yy % 4 == 0 and (yy % 100 != 0 or yy % 400 == 0))
    dim = t_dt.days_in_month(torch.from_numpy(y), torch.from_numpy(m))
    np.testing.assert_array_equal(
        dim.numpy(), np.asarray(g_dt.days_in_month(jnp.asarray(y),
                                                    jnp.asarray(m))))


@pytest.mark.parametrize("literal", [-90, 0, 3])
def test_date32_plus_interval_literal_in_a_filter(literal):
    """A date32 column against ``add(date32 literal, interval_day literal)``
    (TPC-H Q1's shipdate bound) through Filter, both packages."""
    import gandiva_tpu as g

    rng = np.random.default_rng(7)
    days = rng.integers(8035, 10561, N).astype(np.int32)
    valid = rng.random(N) >= 0.05
    sels = []
    for p, batch in zip((g, gt), batches(
            {"d": ("date32", days, valid, None)}, N)):
        dt, B = p.dtypes, p.TreeExprBuilder
        f = dt.Field("d", dt.date32)
        bound = B.make_function(
            "add", [B.make_literal(10561, dt.date32),
                    B.make_interval_day_literal(literal)], dt.date32)
        cond = B.make_condition(B.make_function(
            "less_than_or_equal_to", [B.make_field(f), bound], dt.bool_))
        kw = {"device": "cpu"} if p is gt else {}
        sels.append(p.make_filter(dt.Schema([f]), cond, use_cache=False,
                                  **kw).evaluate(batch).to_numpy())
    np.testing.assert_array_equal(sels[1], sels[0])
    np.testing.assert_array_equal(
        sels[1], np.nonzero(valid & (days <= 10561 + literal))[0])
