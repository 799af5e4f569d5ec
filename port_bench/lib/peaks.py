"""Published peaks of the cards the benchmark knows, dense, without
sparsity, at the full power limit (NVIDIA's H100 SXM data sheet).  A card
whose name matches no entry has no peaks, and the metrics that need them
report nothing."""
from __future__ import annotations

from typing import Dict, Optional

PEAKS = {
    "H100": {
        "tf32_flops": 495e12,
        "bf16_flops": 989e12,
        "fp32_flops": 67e12,
        "hbm_bytes_per_s": 3.35e12,
    },
}


def peaks(device_name: str) -> Optional[Dict[str, float]]:
    for key, table in PEAKS.items():
        if key in device_name:
            return table
    return None
