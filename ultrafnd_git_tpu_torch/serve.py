"""Serve a model directory, a training out_dir or a frozen artifact over HTTP
(counterpart of scripts/serve.py).

    python -m ultrafnd_git_tpu_torch.serve --model_dir D [--port 8080] \
        [--bf16] [--quantize] [--serve_dp N] [--device cuda|cpu | --cpu]
    python -m ultrafnd_git_tpu_torch.serve --out_dir O [--checkpoint best|latest] ...
    python -m ultrafnd_git_tpu_torch.serve --artifact A [--port 8080] [--device cuda|cpu]
    curl -s localhost:8080/healthz
    curl -s -X POST localhost:8080/predict \
        -d '{"records": [{"video_id": "x", "title": "...", "ocr": "...", "comments": []}]}'
    curl -s -X POST localhost:8080/explain -d '{"records": [...], "method": "shap"}'

`--model_dir` is a model directory from `scripts/export_torch_model.py` or
`python -m ultrafnd_git_tpu_torch.train --export_model_dir`; `--out_dir` a
run of that trainer, served from its `--checkpoint` slot; `--artifact` a
frozen artifact from `python -m ultrafnd_git_tpu_torch.export_serving`
(pass exactly one; an artifact's `--bf16` and `--quantize` were fixed at
export, and /explain answers 500 for it). The flags are scripts/serve.py's,
`--serve_dp N` included (each dispatch's rows split over N devices,
`serving.Predictor`'s serve_dp); `--device` stands beside `--cpu`. The
device defaults to cuda and raises when there is no GPU.
"""
from __future__ import annotations

import argparse
import time

from ultrafnd_git_tpu_torch.predict import (
    add_serve_dp_arg,
    add_source_args,
    check_source_args,
    make_predictor,
)
from ultrafnd_git_tpu_torch.utils.device import add_device_args, resolve_cpu_flag


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="ultrafnd_git_tpu_torch — HTTP serving")
    add_source_args(ap)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--batch_size", type=int, default=64)
    add_device_args(ap)
    ap.add_argument("--bf16", action="store_true",
                    help="bf16 tower, fusion and classifier (the tower's attention "
                         "on the bf16 flash kernel); scores move within the bf16 envelope")
    ap.add_argument("--quantize", action="store_true",
                    help="int8 serving weights with per-channel scales, dequantized "
                         "right before use (ops/quant.py)")
    ap.add_argument("--verbose", action="store_true", help="log one line per HTTP request")
    ap.add_argument("--batch_window_ms", type=float, default=4.0,
                    help="dynamic-batching window: concurrent /predict requests "
                         "arriving within it coalesce into one device dispatch (exact: "
                         "scoring is row-independent); negative disables coalescing; 0 "
                         "still coalesces whatever queued while the device was busy")
    ap.add_argument("--max_batch", type=int, default=4096,
                    help="max coalesced records per dispatch")
    ap.add_argument("--gap_ms", type=float, default=3.0,
                    help="close the batching window early once arrivals go quiet "
                         "for this long (the window is the longest wait)")
    add_serve_dp_arg(ap)
    ap.add_argument("--warmup", type=int, default=64, metavar="N",
                    help="run the bucket ladder up to N records before opening the "
                         "socket (builds the kernels; 0 disables)")
    args = resolve_cpu_flag(ap.parse_args(argv))
    check_source_args(ap, args)
    return args


def main(argv=None) -> None:
    args = parse_args(argv)
    from ultrafnd_git_tpu_torch.server import make_server

    predictor = make_predictor(args)
    if args.warmup > 0:
        t0 = time.perf_counter()
        n_buckets = predictor.warmup(args.warmup)
        print(f"warmup: {n_buckets} bucket sizes in {time.perf_counter() - t0:.1f}s",
              flush=True)
    server = make_server(
        predictor,
        host=args.host,
        port=args.port,
        quiet=not args.verbose,
        batch_window_ms=None if args.batch_window_ms < 0 else args.batch_window_ms,
        max_batch=args.max_batch,
        gap_ms=args.gap_ms,
    )
    host, port = server.server_address[:2]
    print(f"serving {args.artifact or args.model_dir or args.out_dir} on http://{host}:{port} "
          "(POST /predict, POST /explain, GET /healthz, GET /stats)", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        print("\nshutting down")
    finally:
        server.server_close()
        if server.batcher is not None:
            server.batcher.close()
        predictor.close()


if __name__ == "__main__":
    main()
