"""Score new records with a model directory, a training out_dir or a frozen artifact.

    python -m ultrafnd_git_tpu_torch.predict --model_dir D --input records.json \
        [--output preds.jsonl] [--batch_size 64] [--device cuda|cpu | --cpu] \
        [--bf16] [--quantize] [--explain [--explain_method grad|shap] [--top_k 8]] \
        [--serve_dp N]
    python -m ultrafnd_git_tpu_torch.predict --out_dir O [--checkpoint best|latest] ...
    python -m ultrafnd_git_tpu_torch.predict --artifact A --input records.json ...

Pass exactly one model source: `--model_dir` (an exported model directory),
`--out_dir` (a run of `python -m ultrafnd_git_tpu_torch.train`, served from
its `--checkpoint` slot, `best` by default, as scripts/predict.py serves a
JAX out_dir) or `--artifact` (a directory from
`python -m ultrafnd_git_tpu_torch.export_serving`, served by
`export_serving.ExportedPredictor`). `--checkpoint` other than best needs
`--out_dir`. An artifact's precision levers are fixed at export, so
`--bf16` and `--quantize` are refused with it, and so is `--explain`,
which needs the full-precision modules. `--serve_dp N` splits each
scoring dispatch's rows over N devices (`serving.Predictor`'s serve_dp).

`--input` is a JSON array or JSONL of records with title / ocr / comments.
Output is one JSON object per record: {id, prob_fake, label,
semantic_conflict, temporal_delay, emotion_intensity}, plus an "explain"
object with --explain. The device defaults to cuda and raises when there
is no GPU; pass --device cpu (or scripts/predict.py's --cpu) to run on the
CPU. Under `ULTRAFND_TEXT_DEVICE=1` the text column of the records comes
from the text tower on that device (`ULTRAFND_TEXT_DEVICE_CKPT`: a trained
one), as in the JAX package.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import List

from ultrafnd_git_tpu_torch.utils.device import add_device_args, resolve_cpu_flag


def load_records(path: Path) -> List[dict]:
    """A JSON array, or one JSON object per line."""
    text = Path(path).read_text(encoding="utf-8-sig")
    if text.lstrip().startswith("["):
        return json.loads(text)
    return [json.loads(ln) for ln in text.splitlines() if ln.strip()]


def add_source_args(ap: argparse.ArgumentParser, artifact: bool = True) -> None:
    """The model source flags: --model_dir, --out_dir with --checkpoint and,
    with `artifact`, --artifact (`check_source_args` takes exactly one)."""
    ap.add_argument("--model_dir", default=None,
                    help="exported model dir (scripts/export_torch_model.py, or the "
                         "trainer's --export_model_dir)")
    ap.add_argument("--out_dir", default=None,
                    help="training out_dir of python -m ultrafnd_git_tpu_torch.train, "
                         "served from its --checkpoint slot")
    ap.add_argument("--checkpoint", default="best", choices=("best", "latest"),
                    help="the --out_dir slot to serve")
    if artifact:
        ap.add_argument("--artifact", default=None,
                        help="frozen serving artifact dir (python -m "
                             "ultrafnd_git_tpu_torch.export_serving)")


def check_source_args(ap: argparse.ArgumentParser, args, artifact: bool = True) -> None:
    """JAX's rules for the source of the weights: exactly one of --model_dir,
    --out_dir and (with `artifact`) --artifact; --checkpoint picks a slot of
    --out_dir only; an artifact's levers were fixed when it was exported."""
    flags = ["--model_dir"] + ["--artifact"] * artifact + ["--out_dir"]
    artifact = args.artifact if artifact else None
    if sum(bool(x) for x in (args.model_dir, args.out_dir, artifact)) != 1:
        ap.error(f"pass exactly one of {' / '.join(flags)}")
    if args.checkpoint != "best" and not args.out_dir:
        ap.error("--checkpoint picks a slot of --out_dir; a model directory or an "
                 "artifact holds one set of weights")
    if artifact:
        for flag, on in (("--bf16", args.bf16), ("--quantize", args.quantize)):
            if on:
                ap.error(f"{flag} is fixed at export time; re-export with "
                         "python -m ultrafnd_git_tpu_torch.export_serving instead")


def make_predictor(args, artifact: bool = True):
    """The Predictor of --model_dir or --out_dir (with --serve_dp where the
    CLI has it), or (with `artifact`) the ExportedPredictor of --artifact."""
    if artifact and args.artifact:
        from ultrafnd_git_tpu_torch.export_serving import ExportedPredictor

        return ExportedPredictor(args.artifact, batch_size=args.batch_size,
                                 device=args.device)
    from ultrafnd_git_tpu_torch.serving import Predictor

    return Predictor(args.model_dir, out_dir=args.out_dir, checkpoint_name=args.checkpoint,
                     batch_size=args.batch_size, device=args.device,
                     bf16=args.bf16, quantize=args.quantize,
                     serve_dp=getattr(args, "serve_dp", None))


def add_serve_dp_arg(ap: argparse.ArgumentParser) -> None:
    """--serve_dp (scripts/predict.py's and scripts/serve.py's)."""
    ap.add_argument("--serve_dp", type=int, default=None,
                    help="split each scoring dispatch's rows over this many devices "
                         "(cuda:0 ... cuda:N-1, weights and corpus replicated; on the "
                         "CPU the blocks run in turn); rows agree with one device's "
                         "to f32 rounding. Ignored with --artifact, as in JAX")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="ultrafnd_git_tpu_torch — predict")
    add_source_args(ap)
    ap.add_argument("--input", required=True, help="JSON array or JSONL of records")
    ap.add_argument("--output", default=None, help="write JSONL here (default: stdout)")
    ap.add_argument("--batch_size", type=int, default=64)
    add_device_args(ap)
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
    add_serve_dp_arg(ap)
    args = resolve_cpu_flag(ap.parse_args(argv))
    check_source_args(ap, args)
    if args.artifact and args.explain:
        ap.error("--explain needs the full-precision modules; use --model_dir or "
                 "--out_dir (see export_serving.ExportedPredictor)")
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
