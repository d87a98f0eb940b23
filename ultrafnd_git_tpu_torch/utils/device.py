"""Device selection for the port: CUDA by default, the CPU only when asked."""
from __future__ import annotations

import torch


def resolve_device(name: str = "cuda") -> torch.device:
    """`"cuda"` (or `"cuda:N"`) -> that GPU, raising when CUDA is absent;
    `"cpu"` -> the CPU, which the main path takes only on explicit request.

    Also turns TF32 off for matmuls and cuDNN: the port is held to the
    JAX reference in full f32, and TF32 keeps about three decimal digits.
    """
    dev = torch.device(name)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {name!r} requested but torch.cuda.is_available() is "
                "False; pass device='cpu' explicitly to run on the CPU"
            )
        if dev.index is not None and dev.index >= torch.cuda.device_count():
            raise RuntimeError(
                f"device {name!r} requested but only "
                f"{torch.cuda.device_count()} CUDA device(s) are visible"
            )
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {name!r}: use 'cuda' or 'cpu'")
    return dev
