"""Unsigned columns at the operators' boundary.

The operators take torch's uint8/16/32/64 tensors (as ``torch.from_numpy``
gives them). Torch has little arithmetic on uint16/32/64, so inside they
are handled as the bits of the signed type of the same width
(``signed_view``) and widen to int64 by zero extension (``widen``).
"""
from __future__ import annotations

import torch

UNSIGNED_VIEW = {torch.uint16: torch.int16, torch.uint32: torch.int32,
                 torch.uint64: torch.int64}
UNSIGNED = (torch.uint8,) + tuple(UNSIGNED_VIEW)


def signed_view(x: torch.Tensor) -> torch.Tensor:
    """uint16/32/64 tensors as the bits of int16/32/64; others unchanged."""
    return x.view(UNSIGNED_VIEW[x.dtype]) if x.dtype in UNSIGNED_VIEW else x


def widen(x: torch.Tensor) -> torch.Tensor:
    """An integer or bool column as int64: signed types sign-extend,
    unsigned ones zero-extend, uint64 keeps its bits."""
    if x.dtype in (torch.uint16, torch.uint32):
        return signed_view(x).to(torch.int64) & ((1 << (8 * x.element_size()))
                                                - 1)
    return signed_view(x).to(torch.int64)
