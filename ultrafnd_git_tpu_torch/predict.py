"""Score new records with an exported model directory (serving CLI).

    python -m ultrafnd_git_tpu_torch.predict --model_dir D --input records.json \
        [--output preds.jsonl] [--batch_size 64] [--device cuda|cpu] \
        [--bf16] [--quantize] [--explain [--explain_method grad|shap] [--top_k 8]]

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


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="ultrafnd_git_tpu_torch — predict")
    ap.add_argument("--model_dir", required=True,
                    help="exported model dir (scripts/export_torch_model.py)")
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

    from ultrafnd_git_tpu_torch.serving import Predictor

    predictor = Predictor(args.model_dir, batch_size=args.batch_size,
                          device=args.device, bf16=args.bf16, quantize=args.quantize)
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
