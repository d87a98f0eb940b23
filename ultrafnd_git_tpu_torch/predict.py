"""Score new records with an exported model directory (serving CLI).

    python -m ultrafnd_git_tpu_torch.predict --model_dir D --input records.json \
        [--output preds.jsonl] [--batch_size 64] [--device cuda|cpu]

`--input` is a JSON array or JSONL of records with title / ocr / comments.
Output is one JSON object per record: {id, prob_fake, label,
semantic_conflict, temporal_delay, emotion_intensity}. The device defaults
to cuda and raises when there is no GPU; pass --device cpu to run on the
CPU.
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
    args = ap.parse_args(argv)

    from ultrafnd_git_tpu_torch.serving import Predictor

    predictor = Predictor(args.model_dir, batch_size=args.batch_size,
                          device=args.device)
    try:
        results = predictor.predict(load_records(Path(args.input)))
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
