#!/usr/bin/env python3
"""What a chunk of the BERT rung costs on one CUDA GPU, for the length-aware
planner of `models/bert.DeviceBertEncoder` (`plan_chunks`).

    python3 scripts/bert_chunk_cost.py [--out build/bert_chunk_cost.json]

At bert-base-uncased's widths (seeded weights, f32, TF32 off):

- `cold`: the first call of a chunk shape the process has not run yet,
  against its second call (host clock, synchronised), after two shapes ran;
- `grid`: a chunk's time (the encoder's forward and the masked mean pool)
  at each (rows, sequence) of a grid, from CUDA events over repeated calls,
  and the least-squares fits time = FLOPs / rate + fixed, in relative and
  in absolute error, the fixed part per chunk also given as FLOPs a layer
  at the fitted rate (`CHUNK_LAYER_FLOPS` comes from these fits and the
  sweep);
- `sweep`: the mean request time over pools of the `encode_fields_r12` and
  `encode_ocr_s256` traffic (`portbench/traffic/`) at several chunk costs
  of the planner, and with one power-of-two bucket a request (the layout
  before the planner), in turns;
- `host`: the planner's and the whole pad step's host time a request.

Prints one JSON line and writes it to `--out`.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
import timeit
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench import traffic as gen  # noqa: E402
from ultrafnd_git_tpu_torch.models import bert  # noqa: E402

CFG = dict(hidden_size=768, num_hidden_layers=12, num_attention_heads=12,
           intermediate_size=3072, vocab_size=30522, max_position_embeddings=512,
           type_vocab_size=2, layer_norm_eps=1e-12)
ROWS = (8, 16, 24, 32, 40, 48, 64, 80, 96, 128, 160, 192, 256)
SEQS = (32, 64, 96, 128, 160, 192, 224, 256)
COSTS = (0.0, 1e10, bert.CHUNK_LAYER_FLOPS, 2.5e10)
TRAFFIC = ("encode_fields_r12", "encode_ocr_s256")


def card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi failed: {exc!r}"


def chunk_inputs(rows, seq, dev, rng):
    lengths = rng.integers(max(1, seq - 31), seq + 1, rows)
    mask = torch.as_tensor(np.arange(seq)[None] < lengths[:, None], dtype=torch.float32,
                           device=dev)
    ids = torch.as_tensor(rng.integers(999, CFG["vocab_size"], (rows, seq)), device=dev)
    return ids, mask


@torch.inference_mode()
def run_chunk(module, ids, mask):
    m = mask[..., None]
    return (module(ids, mask) * m).sum(dim=1) / m.sum(dim=1).clamp_min(1e-6)


def host_ms(fn) -> float:
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t)


def event_ms(fn, calls: int) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def requests(name, n, rng):
    traffic = json.loads((Path(__file__).resolve().parents[1]
                          / f"portbench/traffic/{name}.json").read_text())
    out = []
    for lengths in gen.request_lengths(traffic, 256)[:n]:
        width = int(lengths.max())
        mask = (np.arange(width)[None] < lengths[:, None]).astype(np.float32)
        ids = rng.integers(999, CFG["vocab_size"], (len(lengths), width)) * mask
        out.append((ids.astype(np.int64), mask))
    return out


def one_bucket(lengths, batch_size, max_length, *_):
    """The layout before the planner: the request in its input order, padded
    to power-of-two (rows, sequence) buckets."""
    seq = bert.seq_bucket(int(lengths.max()), max_length)
    return [(np.arange(s, min(s + batch_size, len(lengths))),
             bert.seq_bucket(min(batch_size, len(lengths) - s), batch_size), seq)
            for s in range(0, len(lengths), batch_size)]


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", default="build/bert_chunk_cost.json")
    p.add_argument("--calls", type=int, default=8, help="timed calls a grid shape")
    p.add_argument("--requests", type=int, default=48, help="pool requests a sweep turn")
    args = p.parse_args()
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    sd = bert.draw_weights_(bert.BertEncoder.from_config(bert.hf_config(CFG)), 11).state_dict()
    enc = bert.DeviceBertEncoder(sd, None, config=CFG)
    module = enc.module
    result = {"card": card(), "torch": torch.__version__, "cuda": torch.version.cuda}

    # cold shapes: the first call of an unseen shape against its second
    for shape in ((128, 256), (64, 256)):
        run_chunk(module, *chunk_inputs(*shape, dev, rng))
    cold = []
    for rows, seq in ((40, 96), (72, 160), (16, 64), (104, 224), (8, 32), (24, 128),
                      (48, 96), (40, 160), (88, 64), (56, 192)):
        inputs = chunk_inputs(rows, seq, dev, rng)
        first = host_ms(lambda: run_chunk(module, *inputs))
        second = host_ms(lambda: run_chunk(module, *inputs))
        cold.append({"rows": rows, "seq": seq, "first_ms": first, "second_ms": second})
    result["cold"] = cold
    result["cold_extra_ms_median"] = float(np.median([c["first_ms"] - c["second_ms"]
                                                      for c in cold]))

    # the grid and the fit
    grid = []
    for rows in ROWS:
        for seq in SEQS:
            inputs = chunk_inputs(rows, seq, dev, rng)
            for _ in range(2):
                run_chunk(module, *inputs)
            ms = event_ms(lambda: run_chunk(module, *inputs), args.calls)
            flops = CFG["num_hidden_layers"] * bert.chunk_flops(rows, seq, 768, 3072)
            grid.append({"rows": rows, "seq": seq, "ms": ms, "tflops": flops / ms / 1e9})
    flops = np.array([g["tflops"] * g["ms"] * 1e9 for g in grid])
    t = np.array([g["ms"] for g in grid])
    result["grid"] = grid
    result["fit"] = {}
    for name, weight in (("relative", 1.0 / t), ("absolute", np.ones_like(t))):
        a = np.stack([flops, np.ones_like(flops)], axis=1) * weight[:, None]
        (per_flop, fixed_ms), *_ = np.linalg.lstsq(a, t * weight, rcond=None)
        result["fit"][name] = {"rate_tflops": 1e-9 / per_flop, "fixed_ms": fixed_ms,
                               "chunk_layer_flops": fixed_ms / per_flop
                               / CFG["num_hidden_layers"]}

    # the sweep: request time over each pool at each chunk cost
    planner = bert.plan_chunks
    layouts = {"one_bucket": one_bucket}
    for cost in COSTS:
        layouts[f"cost_{cost:.2e}"] = (lambda c: lambda *a: planner(*a[:5], chunk_cost=c))(cost)
    result["sweep"] = {}
    for traffic in TRAFFIC:
        reqs = requests(traffic, args.requests, rng)
        for layout in layouts.values():  # warm every shape of the pool
            bert.plan_chunks = layout
            for r in reqs:
                enc.encode_ids(*r)
        sweep = {name: [] for name in layouts}
        for turn in range(2):
            for name in (list(layouts) if turn == 0 else list(layouts)[::-1]):
                bert.plan_chunks = layouts[name]
                before = (bert.encode_chunks, bert.encode_padded_slots, bert.encode_real_slots)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for r in reqs:
                    enc.encode_ids(*r)
                ms = 1e3 * (time.perf_counter() - t0) / len(reqs)
                chunks, slots, real = (now - b for now, b in zip(
                    (bert.encode_chunks, bert.encode_padded_slots, bert.encode_real_slots),
                    before))
                sweep[name].append({"request_ms": ms, "chunks_a_request": chunks / len(reqs),
                                    "pad_share": 1.0 - real / slots})
        result["sweep"][traffic] = sweep
    bert.plan_chunks = planner

    # the host side of a request
    reqs = requests(TRAFFIC[0], args.requests, rng)
    lengths = [bert.string_lengths(m) for _, m in reqs]
    n = 200
    plan_us = [1e6 * timeit.timeit(lambda: bert.plan_chunks(L, 256, 256, 768, 3072), number=n)
               / n for L in lengths]
    pad_us = [1e6 * timeit.timeit(lambda: enc._padded(*r), number=n) / n for r in reqs]
    result["host"] = {"plan_us_median": float(np.median(plan_us)),
                      "plan_us_max": float(np.max(plan_us)),
                      "pad_us_median": float(np.median(pad_us)),
                      "pad_us_max": float(np.max(pad_us))}
    line = json.dumps(result)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(line + "\n")
    print(json.dumps({k: v for k, v in result.items() if k != "grid"}))


if __name__ == "__main__":
    main()
