"""The join probe, hand-written in CUDA for Hopper: each probe row walks its
own chain of the build's linear-probed table.

Replaces no Pallas kernel: the reference probes with array operations
(``gandiva_tpu/ops/hash_join.py::_probe_ranges_dense`` and
``_probe_ranges_hot``: full-width gathers, compactions of the rows left over,
chain walks one gather a round, a sampled hot-key tier). The plain version
is the port's torch chain in ``ops/hash_join.py::_probe_ranges_table``,
which CPU tensors take; ``probe_ranges_cuda`` is what CUDA tensors take.
Source: ``csrc/join_probe.cu``, built by ``build.py`` and bound with ctypes.

Contract: over ``n`` probe rows, ``pk64`` the int64 keys after
``normalize_key`` and ``_widen`` and ``probe_kv`` a bool a row, against a
table int32 [T_tot, 4] of ``T`` home slots from the join build, (start,
len) int32 [n] per row: a row outside ``probe_kv`` gets (0, 0) and reads no
slot; a valid row walks from ``hash32(key) % T`` onward, not wrapping, and
gets the (start, len) of the slot that holds its key, or (0, 0) at the
first empty slot. They equal ``_probe_ranges_dense``'s bit for bit on every
row, and ``_probe_ranges_hot``'s on every row in ``probe_kv``.

Bound: bytes, 17 B a row (key, validity, start and len) and 16 B a slot a
valid row reads (one at its home, one more a step of its chain), the slot
reads random. The design (several rows' home-slot loads in flight a thread,
read-only loads of the table) is described in the source.

One launch a probe of at least one row, no host sync, nothing allocated
but the two outputs. ``LAUNCHES["join_probe"]`` counts the launches.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import LAUNCHES, build
from .compaction import _check


def library() -> ctypes.CDLL:
    """The join probe's kernel library, built at first use."""
    lib = build.load("join_probe")
    if not getattr(lib, "_gt_typed", False):
        vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.gt_join_probe.argtypes = [vp, vp, ll, vp, ll, ll, vp, vp, vp]
        lib.gt_join_probe.restype = ci
        lib.gt_error_string.argtypes = [ci]
        lib.gt_error_string.restype = ctypes.c_char_p
        lib._gt_typed = True
    return lib


def _validate(pk64: torch.Tensor, probe_kv: torch.Tensor,
              table: torch.Tensor, T: int) -> None:
    if pk64.dtype != torch.int64 or pk64.dim() != 1:
        raise ValueError(f"probe_ranges_cuda takes 1-D int64 keys, got "
                         f"{pk64.dtype} of shape {tuple(pk64.shape)}")
    if probe_kv.dtype != torch.bool or probe_kv.shape != pk64.shape:
        raise ValueError(f"probe_kv must be a bool a key, got "
                         f"{probe_kv.dtype} of shape "
                         f"{tuple(probe_kv.shape)}")
    if table.dtype != torch.int32 or table.dim() != 2 \
            or table.shape[1] != 4:
        raise ValueError(f"the table must be int32 [T_tot, 4], got "
                         f"{table.dtype} of shape {tuple(table.shape)}")
    if not 0 < T <= table.shape[0]:
        raise ValueError(f"T must lie in [1, {table.shape[0]}], got {T}")
    for name, t in (("keys", pk64), ("probe_kv", probe_kv),
                    ("table", table)):
        if not t.is_contiguous():
            raise ValueError(f"probe_ranges_cuda takes contiguous tensors; "
                             f"{name} is not")
        if t.device.type != "cuda" or t.device != pk64.device:
            raise ValueError(f"probe_ranges_cuda takes tensors on one CUDA "
                             f"card, got {name} on {t.device}")
    if table.data_ptr() % 16:
        raise ValueError("the table must start on a 16-byte boundary")


def probe_ranges_cuda(pk64: torch.Tensor, probe_kv: torch.Tensor,
                      table: torch.Tensor, T: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(start, len), int32 [n] each, of the probe keys ``pk64`` against
    ``table`` on their card, in one launch."""
    _validate(pk64, probe_kv, table, T)
    n = pk64.shape[0]
    dev = pk64.device
    start = torch.empty(n, dtype=torch.int32, device=dev)
    ln = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return start, ln
    lib = library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _check(lib, lib.gt_join_probe(
            pk64.data_ptr(), probe_kv.data_ptr(), n, table.data_ptr(), T,
            table.shape[0], start.data_ptr(), ln.data_ptr(), stream),
            "gt_join_probe")
    LAUNCHES["join_probe"] += 1
    return start, ln
