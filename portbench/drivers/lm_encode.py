"""Driver of the text ladder's language-model rung: `DeviceLfm2Encoder.encode_ids`
under one closed-loop caller.

Set-up draws the configuration's weights from the seed on the device in
one flat f32 draw (`weights.draw`; `reference.even_bias_` fixes the expert
bias's values, the draw their order), hands them to the encoder as a state
dict and config mapping (which makes its bf16 tensors on the device from
them; the ladder's loader and host tokenizer are bypassed) and frees the
draw before the warm-up; it makes the traffic file's pool of requests
(`traffic.py`) and sends a few requests, one of each padded shape of the
pool among them. The window sends the pool's requests one after another,
cycling, each timed from the call to its rows on the host, until
`--seconds` have passed; the expert layers' counters
(`models/lfm2.moe_counters`, kept while spans are recorded: the traced
run's window) are read at its start and end. Once it has
closed, a sample of the finished requests is drawn from the seed, with
the one of most tokens in it, and each is sent once more with the expert
layers' choices captured, each checked against the reference's router
on the layer's own input, and with a sample of each expert-layer call's
input and output rows (`program_pass`). Once the encoder is freed, the
plain reference (`reference/lfm2_encoder.py`) runs on the same draw
rounded as the program holds it (bf16, the router f32) and upcast to f32.
Three numbers are compared:

* `rows`: the largest gap of a row element between the window's rows and
  the reference's rows of the same request, routed as the program routed
  (the rows being unit vectors; the reference module says why the routing
  is taken from the program);
* `experts`: each sampled expert-layer call's output rows against the
  reference's expert layer on the same input rows (the program's, upcast),
  routed as the program routed: the largest element gap over the
  reference's largest element, the largest over calls. The 24 layers of
  bf16 before the end carry the rounding of each on to the rows, which
  hides a lower precision of the experts alone there; here each layer's
  own arithmetic is held to f32;
* `routes`: over every routed token of the sampled requests, in every
  expert layer, on the program's own input to that layer, the largest
  shortfall, in score + bias, of an expert the program chose from the
  reference's own k-th choice (0 where they agree; the router is f32 on
  both sides, its weights the draw's, kept apart before the encoder is
  built). Every choice that `rows` and `experts` take from the program
  is so held.

The control (`ctx.control`) is the reference again with every
projection's weights rounded to fp8 e4m3 (a scale a row), the nearest
precision below the configuration's bf16, in the program's place.

In the traced run the window is `spans.make_drive`'s: the program's spans
are recorded over it beside the device's operations, and a forward
pre-hook on the encoder's module counts each chunk's padded (rows,
sequence) (the causal attention's shapes) and its real positions
(`encode.pad_share`)."""
from __future__ import annotations

import gc
import sys
import time
from typing import Any, Dict, List

import numpy as np
import torch

from portbench import check, traffic as gen, weights, window as plain
from portbench.flops import lfm2_8b_a1b as flops
from portbench.reference import lfm2_encoder as ref
from portbench.spans import make_drive
from portbench.window import drive, peak_bytes, sync

FP8_LEAVES = ("proj.weight", "w1.weight", "w2.weight", "w3.weight")
ROWS_A_CALL = 64  # expert-layer rows sampled a call for `experts` and `routes`


def _pow2(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


def _free(dev: torch.device) -> None:
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def fp8_rows_(t: torch.Tensor) -> torch.Tensor:
    """t rounded in place to fp8 e4m3, each row scaled to e4m3's range."""
    scale = t.abs().amax(dim=-1, keepdim=True).clamp_min(1e-30) / 448.0
    return t.copy_((t / scale).to(torch.float8_e4m3fn).float() * scale)


def program_pass(enc, ids: np.ndarray, mask: np.ndarray, cfg, router):
    """Send one request through the encoder again, capturing each expert
    layer's choices and a sample of its calls' rows: (its rows, {layer:
    (N, L, k) int16 on the host, the experts of each real position, -1 at
    padding}, [(layer, input rows, output rows, their experts)] on the
    host, ROWS_A_CALL rows a call at an even stride, {"routes": the largest
    route gap of every call's choices on its own input against `router`
    (the reference's router weights; `ref.route_gap`), "busiest", "rows":
    the busiest expert's rows summed over calls, and all rows routed})."""
    from ultrafnd_git_tpu_torch.models.lfm2 import SparseMoe

    layers = [i for i, layer in enumerate(enc.module.layers) if not layer.is_dense]
    chunks: List[Dict[str, Any]] = []
    calls: List[Any] = []
    held = {"routes": 0.0, "busiest": 0, "rows": 0}

    def pre(module, args):
        chunks.append({"real": args[2].cpu(), "sel": {}})

    def capture(i, moe):
        def route(x):
            sel, gates = SparseMoe.route(moe, x)
            chunks[-1]["sel"][i] = sel.cpu()
            held["routes"] = max(held["routes"], check.finite_or_inf(
                ref.route_gap(cfg, router, i, x.float(), sel)))
            counts = torch.bincount(sel.flatten(), minlength=cfg["num_experts"])
            held["busiest"] += int(counts.max()) if sel.numel() else 0
            held["rows"] += sel.numel()
            return sel, gates
        return route

    def sample(i):
        def hook(module, args, out):
            pick = torch.arange(0, out.shape[0], max(1, out.shape[0] // ROWS_A_CALL))
            calls.append((i, args[0][pick.to(out.device)].cpu(), out[pick.to(out.device)].cpu(),
                          chunks[-1]["sel"][i][pick]))
        return hook

    handles = [enc.module.register_forward_pre_hook(pre)]
    for i in layers:
        moe = enc.module.layers[i].feed_forward
        moe.route = capture(i, moe)
        handles.append(moe.register_forward_hook(sample(i)))
    try:
        rows = enc.encode_ids(ids, mask)
    finally:
        for h in handles:
            h.remove()
        for i in layers:
            del enc.module.layers[i].feed_forward.route
    plan = enc._padded(ids, mask)[0]
    k = enc.module.layers[layers[0]].feed_forward.top_k
    routes = {i: torch.full((*ids.shape, k), -1, dtype=torch.int16) for i in layers}
    for (rows_of, _, seq), chunk in zip(plan[::-1], chunks):  # the longest chunk runs first
        strings = torch.as_tensor(rows_of)[chunk["real"] // seq]
        for i, sel in chunk["sel"].items():
            routes[i][strings, chunk["real"] % seq] = sel.to(torch.int16)
    return rows, routes, calls, held


def expert_gaps(cfg, wts, calls, dev) -> Dict[str, float]:
    """{"experts", "routes"} of the sampled expert-layer calls against the
    reference's expert layer on the same input rows (the program's own
    `routes` is held over every call, in `program_pass`)."""
    experts = routes = 0.0
    for layer, x, y, sel in calls:
        want, shortfall = ref.expert_layer(cfg, wts, layer, x.to(dev, torch.float32),
                                           sel.to(dev, torch.int64))
        scale = float(want.abs().max())
        experts = max(experts, check.finite_or_inf(
            float((y.to(dev, torch.float32) - want).abs().max()) / max(scale, 1e-30)))
        routes = max(routes, check.finite_or_inf(shortfall))
    return {"experts": experts, "routes": routes}


def run(ctx) -> Dict[str, Any]:
    from ultrafnd_git_tpu_torch.models import lfm2

    cfg, traffic = ctx.cfg, ctx.traffic
    dev = torch.device(ctx.device)
    lad = cfg["ladder"]
    stamps = {"start": time.perf_counter() - ctx.t0}
    spec = ref.param_spec(cfg)
    drawn = ref.even_bias_(cfg, weights.draw(spec, ctx.seed, dev)["lm"])
    stamps["draw"] = time.perf_counter() - ctx.t0
    # the reference's router weights, for `routes` (f32 in the program too)
    router = {n: t.clone() for n, t in drawn.items() if n.endswith(ref.F32_LEAVES)}
    enc = lfm2.DeviceLfm2Encoder(drawn, None, cfg, dim=lad["dim"],
                                 max_length=lad["max_length"], batch_size=lad["batch_size"],
                                 device=ctx.device)
    del drawn
    _free(dev)
    stamps["encoder"] = time.perf_counter() - ctx.t0
    requests = gen.make_requests(traffic, cfg, ctx.seed)
    stamps["requests"] = time.perf_counter() - ctx.t0
    shapes = set()
    for k, r in enumerate(requests):  # a few, and one of each padded shape of the pool
        key = (_pow2(r["ids"].shape[0]), _pow2(r["ids"].shape[1]))
        if key not in shapes or k < 3:
            shapes.add(key)
            enc.encode_ids(r["ids"], r["mask"])
    sync(dev)
    setup_peak = peak_bytes(dev)
    setup_s = time.perf_counter() - ctx.t0
    stamps["warm_up"] = setup_s
    print(f"lm_encode: set-up reached, s after the start: {stamps}; "
          f"set-up peak {setup_peak / 2 ** 30:.2f} GiB", file=sys.stderr)

    chunks: List[Any] = []  # (rows, seq, real positions) of each forward call
    hook = None
    if ctx.trace:
        def count(module, args):
            chunks.append((int(args[0].shape[0]), int(args[0].shape[1]), int(args[2].numel())))
        hook = enc.module.register_forward_pre_hook(count)
    outputs: List[Any] = []
    counters: Dict[str, Any] = {}

    def request(i):
        if i == 0:
            counters["start"] = lfm2.moe_counters()
        r = requests[i % len(requests)]
        first_chunk = len(chunks)
        t0 = time.perf_counter()
        try:
            out = enc.encode_ids(r["ids"], r["mask"])
            t1 = time.perf_counter()
        except Exception as exc:  # a failed request counts as missing
            print(f"lm_encode: request {i} failed: {exc!r}", file=sys.stderr)
            out, t1 = None, None
        outputs.append(out)
        mine = chunks[first_chunk:]
        u = {"t0": t0, "t1": t1, "rows": len(r["lengths"]), "tokens": int(r["lengths"].sum()),
             "flops": flops.real_flops(cfg, r["lengths"]),
             "attn_fwd": [s for rows, seq, _ in mine
                          for s in flops.attention_shapes(cfg, rows, seq)]}
        if mine:
            u["slots"] = sum(rows * seq for rows, seq, _ in mine)
            u["real"] = sum(real for _, _, real in mine)
        return u

    # the traced run records the program's spans, unless a caller has put
    # its own window in `drive` (`python3 -m portbench.spans`)
    window = make_drive(True, {}) if ctx.trace and drive is plain.drive else drive
    units, window_s, window_peak, traced = window(dev, ctx.seconds, ctx.trace,
                                                  traffic["host_units"], request)
    counters["end"] = lfm2.moe_counters()
    del outputs[len(units):]  # what the units after the window left
    if hook is not None:
        hook.remove()
    rec = {"setup_s": setup_s, "window_s": window_s, "units": units, "trace": traced,
           "memory": {"window_peak_bytes": window_peak, "setup_peak_bytes": setup_peak},
           "cfg": cfg, "lm": {"counters": counters, "experts": cfg["num_experts"]}}

    # the sample: drawn from the seed among the finished requests, with the
    # one of most tokens; the experts each chose, from one more pass
    done = [k for k, o in enumerate(outputs) if o is not None]
    rng = np.random.default_rng(ctx.seed)
    sample = []
    if done:
        longest = max(done, key=lambda k: units[k]["tokens"])
        rest = [k for k in done if k != longest]
        take = min(len(rest), traffic["check_requests"] - 1)
        sample = [longest] + sorted(rng.choice(rest, size=take, replace=False).tolist())
    routes, calls, again = [], [], 0.0
    held = {"routes": 0.0, "busiest": 0, "rows": 0}
    for k in sample:
        r = requests[k % len(requests)]
        rows, taken, sampled, of_pass = program_pass(enc, r["ids"], r["mask"], cfg, router)
        routes.append(taken)
        calls += sampled
        held = {"routes": max(held["routes"], of_pass["routes"]),
                "busiest": held["busiest"] + of_pass["busiest"],
                "rows": held["rows"] + of_pass["rows"]}
        again = max(again, float(np.abs(rows - outputs[k]).max()))
    del enc, request
    _free(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    wts = ref.as_program_holds(ref.even_bias_(cfg, weights.draw(spec, ctx.seed, dev)["lm"]))
    inputs = [(torch.as_tensor(requests[k % len(requests)]["ids"], device=dev),
               torch.as_tensor(requests[k % len(requests)]["mask"], device=dev))
              for k in sample]
    numbers = {"rows": float("inf"), "experts": float("inf"), "routes": float("inf")}
    if sample:
        numbers = {"rows": 0.0, "experts": expert_gaps(cfg, wts, calls, dev)["experts"],
                   "routes": held["routes"]}
    wants = []
    for k, (ids, mask), taken in zip(sample, inputs, routes):
        wants.append(ref.encode(cfg, wts, ids, mask, lad["dim"], taken)[0].cpu())
        numbers["rows"] = max(numbers["rows"],
                              check.max_row_gap(torch.as_tensor(outputs[k]), wants[-1]))
    control = {}
    if ctx.control:  # the fp8 reference in the program's place
        low_calls = [(layer, x, ref.expert_layer(cfg, wts, layer, x.to(dev, torch.float32),
                                                 sel.to(dev, torch.int64))[0].cpu(), sel)
                     for layer, x, _, sel in calls]
        for name, t in wts.items():
            if name.endswith(FP8_LEAVES):
                fp8_rows_(t)
        control = {"rows": 0.0, **expert_gaps(cfg, wts, low_calls, dev)}
        for (ids, mask), taken, want in zip(inputs, routes, wants):
            low = ref.encode(cfg, wts, ids, mask, lad["dim"], taken)[0].cpu()
            control["rows"] = max(control["rows"], check.max_row_gap(low, want))
    check_peak = peak_bytes(dev)
    lat = sorted(1e3 * (u["t1"] - u["t0"]) for u in units if u["t1"] is not None)
    if lat:
        q = {p: round(lat[min(len(lat) - 1, int(p / 100 * len(lat)))], 3) for p in (5, 50, 90, 95, 99)}
        print(f"lm_encode: request ms, finished: quantiles {q}, max {lat[-1]:.3f}",
              file=sys.stderr)
    failed = sum(u["t1"] is None for u in units)  # in the window
    print(f"lm_encode: {len(units)} requests, {failed} failed, compared {len(sample)}: "
          f"{sample}; peak GiB set-up {setup_peak / 2 ** 30:.2f}, window "
          f"{window_peak / 2 ** 30:.2f}, reference {check_peak / 2 ** 30:.2f}; "
          f"a second pass's rows within {again!r} of the window's; the sample's "
          f"busiest expert over the mean "
          f"{held['busiest'] * cfg['num_experts'] / max(held['rows'], 1)!r}; "
          f"expert counters {counters}", file=sys.stderr)
    out = {"rec": rec, "numbers": numbers, "attempted": len(units),
           "failed": failed, "memory_peak_bytes": max(setup_peak, window_peak)}
    if ctx.control:
        out["control"] = control
    return out
