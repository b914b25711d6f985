"""What the scan references share: money as the configuration states it
(exact DECIMAL(15,2), as int64 cents) or, for the control, in float32."""
from __future__ import annotations

import torch

EXACT, FLOAT32 = "exact", "float32"


def dollars(cents: torch.Tensor) -> torch.Tensor:
    """A money column in float32 units: the control's precision."""
    return cents.to(torch.float32) / 100


def unscaled(x: torch.Tensor, scale: int) -> torch.Tensor:
    """A float result at ``scale`` digits, as the unscaled int64 a decimal
    of that scale holds (rounded half away from zero)."""
    v = x.to(torch.float64) * 10 ** scale
    return (v.sign() * (v.abs() + 0.5).floor()).to(torch.int64)


def codes_where(codes: torch.Tensor, dictionary, pred) -> torch.Tensor:
    """Rows whose string value satisfies ``pred``, by a table over the
    dictionary's values."""
    table = torch.tensor([bool(pred(v)) for v in dictionary],
                         device=codes.device)
    return table[codes.long()]
