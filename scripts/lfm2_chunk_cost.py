#!/usr/bin/env python3
"""A chunk's cost in the LM rung (`models/lfm2.DeviceLfm2Encoder`) on the
card, for its planner's fixed cost a chunk (`lfm2.CHUNK_LAYER_FLOPS`).

    python3 scripts/lfm2_chunk_cost.py [--out build/lfm2_chunk_cost.json]

Builds the encoder at LFM2-8B-A1B's published widths in bf16 (portbench's
configuration, weights from a seed), times one chunk's forward (every
position real) at a grid of padded (rows, sequence) shapes with CUDA events,
and fits time = FLOPs / rate + fixed over the grid (weighted by 1 / time,
so that the small chunks count). The fixed time at the fitted rate, over
the layers, is the planner's cost a chunk a layer in FLOPs. Prints one JSON
line, also written to --out."""
import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

GRID = [(rows, seq) for rows in (8, 32, 64, 128, 256) for seq in (32, 64, 128, 256)]


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", default="build/lfm2_chunk_cost.json")
    p.add_argument("--calls", type=int, default=5, help="timed calls a grid shape")
    args = p.parse_args()
    import torch

    from portbench import weights
    from portbench.flops import lfm2_8b_a1b as lm_flops
    from portbench.reference import lfm2_encoder as ref
    from ultrafnd_git_tpu_torch.models import lfm2

    dev = torch.device("cuda")
    cfg = json.loads((REPO / "portbench" / "configs" / "lfm2_8b_a1b.json").read_text())
    drawn = weights.draw(ref.param_spec(cfg), 7, dev)["lm"]
    enc = lfm2.DeviceLfm2Encoder(drawn, None, cfg, device="cuda")
    del drawn
    torch.cuda.empty_cache()
    rng = np.random.default_rng(0)
    points = []
    with torch.inference_mode():
        for rows, seq in GRID:
            ids = torch.as_tensor(rng.integers(400, cfg["vocab_size"], (rows, seq)), device=dev)
            mask = torch.ones((rows, seq), device=dev)
            real = torch.arange(rows * seq, device=dev)
            enc.forward(ids, mask, real)  # warm the shape
            start = [torch.cuda.Event(enable_timing=True) for _ in range(args.calls)]
            end = [torch.cuda.Event(enable_timing=True) for _ in range(args.calls)]
            torch.cuda.synchronize()
            for s, e in zip(start, end):
                s.record()
                enc.forward(ids, mask, real)
                e.record()
            torch.cuda.synchronize()
            ms = float(np.median([s.elapsed_time(e) for s, e in zip(start, end)]))
            flop = rows * lm_flops.string_flops(cfg, seq)
            points.append({"rows": rows, "seq": seq, "ms": ms, "tflops": flop / ms / 1e9})
            print(json.dumps(points[-1]), file=sys.stderr, flush=True)
    t = np.array([q["ms"] for q in points])
    f = np.array([q["rows"] * lm_flops.string_flops(cfg, q["seq"]) for q in points])
    a = np.stack([f, np.ones_like(f)], axis=1) / t[:, None]
    (per_flop, fixed_ms), *_ = np.linalg.lstsq(a, t / t, rcond=None)
    result = {"card": torch.cuda.get_device_name(0), "points": points,
              "rate_tflops": 1e-9 / per_flop, "fixed_ms": fixed_ms,
              "chunk_layer_flops": fixed_ms / per_flop / cfg["num_hidden_layers"],
              "at": time.strftime("%Y-%m-%d")}
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(result) + "\n")
    print(json.dumps(result))


if __name__ == "__main__":
    main()
