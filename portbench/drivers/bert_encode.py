"""Driver of the text ladder's BERT rung: `DeviceBertEncoder.encode_ids`
under one closed-loop caller.

Set-up draws the configuration's weights from the seed on the device and
hands them to the encoder as a state dict and config mapping (the ladder's
loader and host tokenizer are bypassed), makes the traffic file's pool of
requests (`traffic.py`) and sends one request of each padded shape the pool
holds. The window sends the pool's requests one after another, cycling,
each timed from the call to its rows on the host, until `--seconds` have
passed. Once it has closed and the encoder is freed, the plain reference
(`reference/bert_encoder.py`) encodes a sample of the finished requests,
drawn from the seed with the one of most tokens in it; the number compared
is the largest gap of a row element, the rows being unit vectors.

In the traced run a forward pre-hook on the encoder's module counts each
chunk's padded (rows, sequence) and its mask's sum: each request's padded
and real slots (`encode.pad_share`) and its chunks' attention shapes."""
from __future__ import annotations

import gc
import sys
import time
from typing import Any, Dict, List

import numpy as np
import torch

from portbench import check, traffic as gen, weights
from portbench.flops import bert_base_uncased as flops
from portbench.reference import bert_encoder as ref
from portbench.window import drive, peak_bytes, sync


def _pow2(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


def run(ctx) -> Dict[str, Any]:
    from ultrafnd_git_tpu_torch.models.bert import DeviceBertEncoder

    cfg, traffic = ctx.cfg, ctx.traffic
    dev = torch.device(ctx.device)
    lad = cfg["ladder"]
    stamps = {"start": time.perf_counter() - ctx.t0}
    spec = ref.param_spec(cfg)
    enc = DeviceBertEncoder(weights.draw(spec, ctx.seed, dev)["bert"], None, dim=lad["dim"],
                            max_length=lad["max_length"], batch_size=lad["batch_size"],
                            device=ctx.device, config=cfg)
    stamps["encoder"] = time.perf_counter() - ctx.t0
    requests = gen.make_requests(traffic, cfg, ctx.seed)
    stamps["requests"] = time.perf_counter() - ctx.t0
    shapes = set()
    for r in requests:  # one request of each padded shape of the pool
        key = (_pow2(r["ids"].shape[0]), _pow2(r["ids"].shape[1]))
        if key not in shapes:
            shapes.add(key)
            enc.encode_ids(r["ids"], r["mask"])
    sync(dev)
    setup_peak = peak_bytes(dev)
    setup_s = time.perf_counter() - ctx.t0
    stamps["warm_up"] = setup_s
    print(f"bert_encode: set-up reached, s after the start: {stamps}", file=sys.stderr)

    chunks: List[Any] = []  # (rows, seq, mask sum) of each forward call
    hook = None
    if ctx.trace:
        def count(module, args):
            chunks.append((int(args[0].shape[0]), int(args[0].shape[1]), args[1].sum()))
        hook = enc.module.register_forward_pre_hook(count)
    outputs: List[Any] = []

    def request(i):
        r = requests[i % len(requests)]
        first_chunk = len(chunks)
        t0 = time.perf_counter()
        try:
            out = enc.encode_ids(r["ids"], r["mask"])
            t1 = time.perf_counter()
        except Exception as exc:  # a failed request counts as missing
            print(f"bert_encode: request {i} failed: {exc!r}", file=sys.stderr)
            out, t1 = None, None
        outputs.append(out)
        mine = chunks[first_chunk:]
        u = {"t0": t0, "t1": t1, "rows": len(r["lengths"]), "tokens": int(r["lengths"].sum()),
             "flops": flops.real_flops(cfg, r["lengths"]),
             "attn_fwd": [s for rows, seq, _ in mine
                          for s in flops.attention_shapes(cfg, rows, seq)]}
        if mine:
            u["slots"] = sum(rows * seq for rows, seq, _ in mine)
            u["real"] = float(sum(m for _, _, m in mine))
        return u

    units, window_s, window_peak, traced = drive(dev, ctx.seconds, ctx.trace,
                                                 traffic["host_units"], request)
    del outputs[len(units):]  # what the units after the window left
    if hook is not None:
        hook.remove()
    rec = {"setup_s": setup_s, "window_s": window_s, "units": units,
           "trace": traced,
           "memory": {"window_peak_bytes": window_peak, "setup_peak_bytes": setup_peak},
           "cfg": cfg}

    del enc, request
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # the sample: drawn from the seed among the finished requests, with the
    # one of most tokens
    done = [k for k, o in enumerate(outputs) if o is not None]
    rng = np.random.default_rng(ctx.seed)
    sample = []
    if done:
        longest = max(done, key=lambda k: units[k]["tokens"])
        rest = [k for k in done if k != longest]
        take = min(len(rest), traffic["check_requests"] - 1)
        sample = [longest] + sorted(rng.choice(rest, size=take, replace=False).tolist())
    wts = weights.draw(spec, ctx.seed, dev)["bert"]
    gap, control = 0.0, 0.0
    for k in sample:
        r = requests[k % len(requests)]
        ids = torch.as_tensor(r["ids"], device=dev)
        mask = torch.as_tensor(r["mask"], device=dev)
        want = ref.encode(cfg, wts, ids, mask, lad["dim"]).cpu()
        gap = max(gap, check.max_row_gap(torch.as_tensor(outputs[k]), want))
        if ctx.control:
            low = ref.encode(cfg, wts, ids, mask, lad["dim"], tf32=True).cpu()
            control = max(control, check.max_row_gap(low, want))
    if not sample:
        gap = float("inf")
    lat = sorted(1e3 * (u["t1"] - u["t0"]) for u in units if u["t1"] is not None)
    if lat:
        q = {p: round(lat[min(len(lat) - 1, int(p / 100 * len(lat)))], 3) for p in (5, 50, 90, 95, 99)}
        print(f"bert_encode: request ms, finished: quantiles {q}, max {lat[-1]:.3f}",
              file=sys.stderr)
    failed = sum(u["t1"] is None for u in units)  # in the window
    print(f"bert_encode: {len(units)} requests, {failed} failed, compared {len(sample)}: "
          f"{sample}", file=sys.stderr)
    out = {"rec": rec, "numbers": {"rows": gap}, "attempted": len(units), "failed": failed,
           "memory_peak_bytes": max(setup_peak, window_peak)}
    if ctx.control:
        out["control"] = {"rows": control}
    return out
