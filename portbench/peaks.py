"""Published peaks of the cards the benchmark runs on (data sheet, dense
rates without sparsity, at the card's full power limit).

A rate of a type is the fastest the card offers any path that takes inputs
of that type: an f32 configuration is held against the dense TF32 rate,
the fastest path that takes f32 inputs."""
from __future__ import annotations

from typing import Dict, Optional

PEAKS: Dict[str, Dict[str, float]] = {
    # NVIDIA H100 SXM5 80 GB: 989 TFLOP/s bf16 / fp16, 495 TF32, 67 f32
    # outside the tensor cores, 3.35 TB/s HBM3
    "NVIDIA H100 80GB HBM3": {"bf16": 989e12, "tf32": 495e12, "fp32": 67e12,
                              "bytes_per_s": 3.35e12},
}


def peaks_for(kind: str) -> Optional[Dict[str, float]]:
    """The peaks of the card named `kind` (torch.cuda.get_device_name), or
    None for a card the table does not hold: no share is read then."""
    return PEAKS.get(kind)
