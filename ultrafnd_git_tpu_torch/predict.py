"""Score new records with an exported model directory or a frozen artifact.

    python -m ultrafnd_git_tpu_torch.predict --model_dir D --input records.json \
        [--output preds.jsonl] [--batch_size 64] [--device cuda|cpu] \
        [--bf16] [--quantize] [--explain [--explain_method grad|shap] [--top_k 8]]
    python -m ultrafnd_git_tpu_torch.predict --artifact A --input records.json ...

Pass exactly one of `--model_dir` and `--artifact` (a directory from
`python -m ultrafnd_git_tpu_torch.export_serving`, served by
`export_serving.ExportedPredictor`). An artifact's precision levers are
fixed at export, so `--bf16` and `--quantize` are refused with it, and so
is `--explain`, which needs the full-precision modules.

`--input` is a JSON array or JSONL of records with title / ocr / comments.
Output is one JSON object per record: {id, prob_fake, label,
semantic_conflict, temporal_delay, emotion_intensity}, plus an "explain"
object with --explain. The device defaults to cuda and raises when there
is no GPU; pass --device cpu to run on the CPU.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import List


def load_records(path: Path) -> List[dict]:
    """A JSON array, or one JSON object per line."""
    text = Path(path).read_text(encoding="utf-8-sig")
    if text.lstrip().startswith("["):
        return json.loads(text)
    return [json.loads(ln) for ln in text.splitlines() if ln.strip()]


def check_source_args(ap: argparse.ArgumentParser, args) -> None:
    """JAX's rules for the source of the weights: exactly one of --model_dir
    and --artifact; an artifact's levers were fixed when it was exported."""
    if bool(args.model_dir) == bool(args.artifact):
        ap.error("pass exactly one of --model_dir / --artifact")
    if args.artifact:
        for flag, on in (("--bf16", args.bf16), ("--quantize", args.quantize)):
            if on:
                ap.error(f"{flag} is fixed at export time; re-export with "
                         "python -m ultrafnd_git_tpu_torch.export_serving instead")


def make_predictor(args):
    """The Predictor of --model_dir, or the ExportedPredictor of --artifact."""
    if args.artifact:
        from ultrafnd_git_tpu_torch.export_serving import ExportedPredictor

        return ExportedPredictor(args.artifact, batch_size=args.batch_size,
                                 device=args.device)
    from ultrafnd_git_tpu_torch.serving import Predictor

    return Predictor(args.model_dir, batch_size=args.batch_size, device=args.device,
                     bf16=args.bf16, quantize=args.quantize)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="ultrafnd_git_tpu_torch — predict")
    ap.add_argument("--model_dir", default=None,
                    help="exported model dir (scripts/export_torch_model.py)")
    ap.add_argument("--artifact", default=None,
                    help="frozen serving artifact dir (python -m "
                         "ultrafnd_git_tpu_torch.export_serving); mutually exclusive "
                         "with --model_dir")
    ap.add_argument("--input", required=True, help="JSON array or JSONL of records")
    ap.add_argument("--output", default=None, help="write JSONL here (default: stdout)")
    ap.add_argument("--batch_size", type=int, default=64)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--bf16", action="store_true",
                    help="bf16 tower, fusion and classifier (the tower's attention "
                         "on the bf16 flash kernel); scores move within the bf16 envelope")
    ap.add_argument("--quantize", action="store_true",
                    help="int8 serving weights with per-channel scales, dequantized "
                         "right before use (ops/quant.py)")
    ap.add_argument("--explain", action="store_true",
                    help="attach per-record classifier attributions (an 'explain' "
                         "object per line)")
    ap.add_argument("--explain_method", default="grad", choices=("grad", "shap"),
                    help="grad = Gradient x Input; shap = KernelSHAP against a "
                         "corpus background")
    ap.add_argument("--top_k", type=int, default=8,
                    help="fused dimensions listed per record with --explain")
    args = ap.parse_args(argv)
    check_source_args(ap, args)
    if args.artifact and args.explain:
        ap.error("--explain needs the full-precision modules; use --model_dir "
                 "(see export_serving.ExportedPredictor)")
    predictor = make_predictor(args)
    try:
        records = load_records(Path(args.input))
        if args.explain:
            results = predictor.explain(records, method=args.explain_method,
                                        top_k=args.top_k)
        else:
            results = predictor.predict(records)
    finally:
        predictor.close()
    sink = open(args.output, "w", encoding="utf-8") if args.output else sys.stdout
    try:
        for r in results:
            sink.write(json.dumps(r, ensure_ascii=False) + "\n")
    finally:
        if args.output:
            sink.close()
            print(f"wrote {len(results)} predictions to {args.output}",
                  file=sys.stderr)


if __name__ == "__main__":
    main()
