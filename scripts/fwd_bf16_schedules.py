#!/usr/bin/env python3
"""Time the bf16 flash-attention forward against other builds of its C
entry, on one CUDA GPU.

    python3 scripts/fwd_bf16_schedules.py                     # the schedule not kept
    python3 scripts/fwd_bf16_schedules.py --previous OLD.cu   # and an earlier design

The shipped kernel, `ultrafnd_git_tpu_torch/csrc/flash_attention_fwd_bf16.cu`,
runs about one CTA an SM (one producer and, at D <= 128, two consumer
warpgroups) over a fixed order of (batch*head, 64-query tile) items. The
alternative schedule is the same source with one consumer warpgroup, one Q
slot and one (K, V) stage a CTA, launch bounds of two 256-thread CTAs an SM
where a wgmma fits in 128 registers (D <= 128; the producer keeps 24, the
consumer rises to 232) and a grid of one CTA an item, so that several CTAs
share an SM: the same TMA and wgmma body under the other schedule. It is
built from a copy of the source with those lines replaced, and the script
raises if the source no longer has them. It must agree with the shipped
kernel bit for bit. Both are timed in turns (shipped, alternative,
alternative, shipped) at the serving bucket (256, 6, 64, 128) and the
training batch (512, 6, 64, 128).

`--previous` names another source of the same C entry (an earlier design,
for example `git show <commit>:ultrafnd_git_tpu_torch/csrc/flash_attention_fwd_bf16.cu`).
It is built as it stands, held to the plain twin (out within 8e-3 of
max|twin|, lse within 1e-4 absolute and relative) and timed in turns with
the shipped kernel at the path shapes and at `chip_smoke.py`'s sweep over
S and D (B * S = 16384, 6 heads).

Times are medians of 30 blocks of 10 calls between CUDA events, each block
behind a sleep lead. Prints one JSON line.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

SHAPES = {"serve": (256, 6, 64, 128), "train": (512, 6, 64, 128)}
SWEEP = ((128, 64), (128, 256), (128, 1024), (128, 2048), (64, 64), (64, 2048),
         (192, 512), (256, 512))  # (D, S), as chip_smoke.py sweeps K2
# shipped line -> the alternative's line
ALTERNATIVE = {
    "  static constexpr int NC = D <= 128 ? 2 : 1;  // consumer warpgroups":
        "  static constexpr int NC = 1;",
    "  static constexpr int NQ = 2;                 // Q slots a consumer":
        "  static constexpr int NQ = 1;",
    "  static constexpr int NS = D == 64 ? 4 : (D == 128 ? 2 : (D == 192 ? 3 : 2));  // (K, V) stages":
        "  static constexpr int NS = 1;",
    "__global__ void __launch_bounds__(384, 1)":
        "__global__ void __launch_bounds__(D <= 128 ? 256 : 384, D <= 128 ? 2 : 1)",
    "  static constexpr int kProducerRegs = 40;":
        "  static constexpr int kProducerRegs = D <= 128 ? 24 : 40;",
    "  const int grid = groups < ctas ? groups : ctas;": "  const int grid = groups;",
}


def build(src: str, name: str):
    """Compile `src` with the kernels' flags; returns its C entry and the
    ptxas register lines."""
    from ultrafnd_git_tpu_torch.kernels import _build

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = _build.BUILD_DIR / f"{name}.cu"
    so = cu.with_suffix(".so")
    cu.write_text(src)
    proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
                           "-o", str(so), str(cu)], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(proc.stdout + proc.stderr)
    fn = ctypes.CDLL(str(so)).ufnd_flash_attention_fwd_bf16
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    regs = [ln.strip() for ln in (proc.stdout + proc.stderr).splitlines() if "registers" in ln]
    return fn, regs


def alternative_source() -> str:
    from ultrafnd_git_tpu_torch.kernels import _build

    src = (_build.CSRC / "flash_attention_fwd_bf16.cu").read_text()
    for old, new in ALTERNATIVE.items():
        if src.count(old) != 1:
            raise RuntimeError(f"the source no longer has the line {old!r}")
        src = src.replace(old, new)
    return src


def inputs(shape, seed, dev):
    import torch

    from ultrafnd_git_tpu_torch.kernels import flash_attention as fa

    b, h, s, d = shape
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(shape, generator=g).to(dev, torch.bfloat16) for _ in range(3))
    lengths = torch.randint(1, s + 1, (b,), generator=g)
    lengths[0] = 0  # a fully masked row
    mask = (torch.arange(s)[None] < lengths[:, None]).float().to(dev)
    return q, k, v, fa.padding_bias(mask, torch.bfloat16)


def median_ms(fn, runs=30, calls=10):
    import torch

    for _ in range(5):
        fn()
    times = []
    for _ in range(runs):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1 << 21)
        e0.record()
        for _ in range(calls):
            fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1) / calls)
    return statistics.median(times)


def against(other, shape, dev, seed=5):
    """The shipped wrapper and `other` (a built C entry) on the same inputs:
    their outputs and times in turns (shipped, other, other, shipped)."""
    import torch

    from ultrafnd_git_tpu_torch.kernels import flash_attention as fa

    b, h, s, d = shape
    q, k, v, bias = inputs(shape, seed, dev)
    out, lse = torch.empty_like(q), torch.empty((b, h, s), device=dev)
    stream = torch.cuda.current_stream().cuda_stream

    def other_call():
        err = other(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), out.data_ptr(),
                    lse.data_ptr(), b, h, s, d, fa._scale(d), stream)
        if err:
            raise RuntimeError(f"launch failed at {shape}: {err}")

    def shipped():
        return fa.flash_attention_fwd_bf16(q, k, v, bias)

    other_call()
    ref, ref_lse = shipped()
    torch.cuda.synchronize()
    twin, twin_lse = fa.reference_attention_bf16(q, k, v, bias)
    t = [median_ms(shipped), median_ms(other_call), median_ms(other_call), median_ms(shipped)]
    scale = twin.float().abs().max().item()
    return {"shape": list(shape), "shipped_ms": [t[0], t[3]], "other_ms": [t[1], t[2]],
            "bit_identical": bool(torch.equal(out, ref) and torch.equal(lse, ref_lse)),
            "other_rel_err": (out.float() - twin.float()).abs().max().item() / scale,
            "other_lse_close": torch.allclose(lse, twin_lse, atol=1e-4, rtol=1e-4)}


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--previous", type=Path, help="another source of the same C entry")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA GPU")
    from ultrafnd_git_tpu_torch.utils.device import resolve_device

    dev = resolve_device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    alt, alt_regs = build(alternative_source(), "fwd_bf16_one_item_a_cta")
    result = {"card": card, "alternative_ptxas": alt_regs}
    ok = True
    with torch.no_grad():
        for key, shape in SHAPES.items():
            row = against(alt, shape, dev)
            ok &= row["bit_identical"]
            result[key] = {"shape": row["shape"], "persistent_ms": row["shipped_ms"],
                           "one_item_a_cta_ms": row["other_ms"],
                           "bit_identical": row["bit_identical"]}
        if args.previous is not None:
            prev, prev_regs = build(args.previous.read_text(), "fwd_bf16_previous")
            rows = []
            shapes = [*SHAPES.values(), *((16384 // s, 6, s, d) for d, s in SWEEP)]
            for shape in dict.fromkeys(shapes):
                row = against(prev, shape, dev)
                ok &= row["other_rel_err"] <= 8e-3 and row["other_lse_close"]
                rows.append({"shape": row["shape"], "shipped_ms": row["shipped_ms"],
                             "previous_ms": row["other_ms"],
                             "previous_rel_err": row["other_rel_err"],
                             "previous_lse_close": row["other_lse_close"]})
            result["previous"] = {"source": str(args.previous), "ptxas": prev_regs, "rows": rows}
    result["ok"] = bool(ok)
    print(json.dumps(result), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
