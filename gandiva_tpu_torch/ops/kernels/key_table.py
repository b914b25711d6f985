"""Membership of keys in a small key table, hand-written in CUDA for
Hopper: one pass over the keys with the table in shared memory.

Replaces no Pallas kernel: the reference compares every key with every
entry of the skew join's hot-key table
(``gandiva_tpu/parallel/ops.py::_is_in_table``), array operations XLA
fuses. The plain version is the port's
``parallel/ops.py::_is_in_table_plain`` (the table read on the host, then
``torch.isin``), which CPU tensors take; ``is_in_table_cuda`` is what CUDA
tensors take. Source: ``csrc/key_table.cu``, built by ``build.py`` and
bound with ctypes.

Contract: over ``n`` int64 keys (the ``key_to_i64`` images) and a table of
at most ``MAX_ENTRIES`` int64 entries with a bool a entry,
``out[r] = any_j(table_valid[j] and keys[r] == table[j])``, bool [n].
Invalid and repeated entries add no member; an all-invalid or empty table
gives all false. The kernel reads ``table_valid`` itself, so nothing is
read on the host.

Bound: bytes, 9 B a key (its int64 read, its flag written). The design
(the table's valid entries as an open-addressed set in each block's shared
memory, 16-byte key loads, 8 flags a store) is described in the source.

One launch a call of at least one key, no host sync, nothing allocated but
the output. ``LAUNCHES["key_table"]`` counts the launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import LAUNCHES, build
from .build import INT, LL, VP, check

MAX_ENTRIES = 1024

_FUNCTIONS = {"gt_key_table": (INT, [VP, LL, VP, VP, LL, VP, VP]),
              "gt_key_table_max_entries": (INT, [])}


def library() -> ctypes.CDLL:
    """The key table's kernel library, built at first use."""
    return build.load("key_table", _FUNCTIONS,
                      {"gt_key_table_max_entries": MAX_ENTRIES})


def _validate(keys64: torch.Tensor, table64: torch.Tensor,
              table_valid: torch.Tensor) -> None:
    for name, t in (("keys", keys64), ("table", table64)):
        if t.dtype != torch.int64 or t.dim() != 1:
            raise ValueError(f"is_in_table_cuda takes 1-D int64 {name}, got "
                             f"{t.dtype} of shape {tuple(t.shape)}")
    if table_valid.dtype != torch.bool or \
            table_valid.shape != table64.shape:
        raise ValueError(f"table_valid must be a bool an entry, got "
                         f"{table_valid.dtype} of shape "
                         f"{tuple(table_valid.shape)}")
    if table64.shape[0] > MAX_ENTRIES:
        raise ValueError(f"the table holds {table64.shape[0]} entries, more "
                         f"than the kernel's {MAX_ENTRIES}")
    for name, t in (("keys", keys64), ("table", table64),
                    ("table_valid", table_valid)):
        if not t.is_contiguous():
            raise ValueError(f"is_in_table_cuda takes contiguous tensors; "
                             f"{name} is not")
        if t.device != keys64.device:
            raise ValueError(f"is_in_table_cuda takes tensors on one device, "
                             f"got keys on {keys64.device} and {name} on "
                             f"{t.device}")
    if keys64.device.type != "cuda":
        raise ValueError(f"is_in_table_cuda takes tensors on a CUDA card, "
                         f"got {keys64.device}")


def is_in_table_cuda(keys64: torch.Tensor, table64: torch.Tensor,
                     table_valid: torch.Tensor) -> torch.Tensor:
    """Whether each key of ``keys64`` equals a valid entry of ``table64``,
    bool [n] on their card, in one launch."""
    _validate(keys64, table64, table_valid)
    n = keys64.shape[0]
    dev = keys64.device
    out = torch.empty(n, dtype=torch.bool, device=dev)
    if n == 0:
        return out
    lib = library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        check(lib, lib.gt_key_table(
            keys64.data_ptr(), n, table64.data_ptr(), table_valid.data_ptr(),
            table64.shape[0], out.data_ptr(), stream), "gt_key_table")
    LAUNCHES["key_table"] += 1
    return out
