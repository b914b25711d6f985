"""Numeric cast kernels (castINT / castBIGINT / castFLOAT4 / castFLOAT8 …).

The torch counterpart of gandiva_tpu.registry.cast. Float→integer casts round
half away from zero (Java semantics, matching Gandiva's use of lround), then
saturate at the target's bounds with NaN → 0, as the reference does on the
CPU (torch's own cast would give INT64_MIN for NaN and for overflow).
Temporal casts live in datetime_ops.py, and the casts to and from strings
in string_ops.py (castVARCHAR, castVARBINARY, castBIGINT(utf8), …).
"""
from __future__ import annotations

from .. import dtypes as dt
from .numeric import (NUMERIC, convert, ctype, emit_float_to_int,
                      emit_to_float, float_to_int, round_half_away)
from .registry import global_registry

_R = global_registry()

_CAST_TARGETS = {
    "castTINYINT": dt.int8,
    "castSMALLINT": dt.int16,
    "castINT": dt.int32,
    "castBIGINT": dt.int64,
    "castFLOAT4": dt.float32,
    "castFLOAT8": dt.float64,
}


def _make_cast(target: dt.DataType):
    def impl(ctx, args):
        a = args[0].value
        src = args[0].dtype
        if src.is_float and target.is_integer:
            return float_to_int(round_half_away(a), target)
        return convert(a, src, target)

    return impl


def _emit_cast(target: dt.DataType):
    """``_make_cast``'s conversion as C++: a float source rounds half away
    from zero in its own type before the saturating conversion."""
    def emit(g, args, rt):
        src, x = args[0].dtype, args[0].v
        if src.is_float and target.is_integer:
            return emit_float_to_int(
                src, target, f"gt_round_half_away<{ctype(src)}>({x})")
        if target.is_float:
            return emit_to_float(src, target, x)
        return f"({ctype(target)})({x})"

    return emit


# identity casts are registered too (planners emit them); bool → numeric
# casts exist via gandiva's castBIT paths
for _name, _target in _CAST_TARGETS.items():
    _impl = _make_cast(_target)
    for _src in NUMERIC + [dt.bool_]:
        _R.register(_name, [_src], _target, _impl, emit=_emit_cast(_target))

# castBIT / castBOOLEAN from numeric
_R.register_many(
    "castBIT", [((t,), dt.bool_) for t in NUMERIC],
    lambda ctx, args: args[0].value != 0, aliases=["castBOOLEAN"],
    emit=lambda g, args, rt: f"({args[0].v} != 0)")
