"""Device selection for the port: CUDA by default, the CPU only when asked."""
from __future__ import annotations

import argparse

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


def to_device(t: torch.Tensor, dev: torch.device, dtype=None) -> torch.Tensor:
    """A host tensor on `dev` (in `dtype`). To CUDA it goes through a pinned
    copy and an asynchronous transfer: a copy from pageable memory would
    wait for the stream to drain, and the device would idle while the host
    enqueues the work after it."""
    t = t if dtype is None else t.to(dtype)
    if dev.type != "cuda":
        return t.to(dev)
    return t.pin_memory().to(dev, non_blocking=True)


def add_device_args(p: argparse.ArgumentParser, help: str = None) -> None:
    """A CLI's `--device cuda|cpu` (cuda by default) and the JAX CLIs'
    `--cpu`, which means `--device cpu` (`resolve_cpu_flag`)."""
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"), help=help)
    p.add_argument("--cpu", action="store_true", help="the same as --device cpu")


def resolve_cpu_flag(args: argparse.Namespace) -> argparse.Namespace:
    """`args` with `--cpu` turned into `args.device = "cpu"`."""
    if args.cpu:
        args.device = "cpu"
    return args
