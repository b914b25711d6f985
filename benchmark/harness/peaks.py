"""Data-sheet peaks of the card (NVIDIA H100 data sheet; dense rates at
the full 700 W power limit), by the name ``torch.cuda.get_device_name``
gives."""
from __future__ import annotations


def hbm_bytes_per_s(name: str) -> float:
    """HBM bandwidth of the H100 part ``name``: PCIe 2.0 TB/s, NVL 3.9
    TB/s, SXM 3.35 TB/s."""
    if "PCIe" in name:
        return 2.0e12
    if "NVL" in name:
        return 3.9e12
    return 3.35e12
