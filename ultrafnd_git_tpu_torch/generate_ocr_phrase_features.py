"""Build the OCR phrase pickle and the placeholder mask hashes (counterpart
of scripts/generate_ocr_phrase_features.py, the same two artifacts):

    python -m ultrafnd_git_tpu_torch.generate_ocr_phrase_features \
        --data_path /data/FakeSV/data_complete.json --out_root .

1) `<out_root>/preprocess_ocr/sam/<vid>.mask.txt`: the md5 of the record's
   sorted regex tokens joined by spaces (a placeholder for a SAM mask);
2) `<out_root>/fakesv/preprocess_ocr/ocr_phrase_fea.pkl`:
   {"phrase_sets": {vid: set}, "freqs": {vid: {tok: n}}}
   (`data/ocr.build_phrase_features`), which `train --ocr_phrase_pkl` reads
   for the corpus graph's tokens.

`--data_path` is a JSON array or JSONL (`predict.load_records`). Host only:
nothing runs on a device.
"""
from __future__ import annotations

import argparse
import hashlib
from pathlib import Path

from ultrafnd_git_tpu_torch.data.ocr import build_phrase_features, save_phrase_features
from ultrafnd_git_tpu_torch.predict import load_records


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="OCR phrase pickle + mask hashes")
    ap.add_argument("--data_path", required=True, help="data_complete.json (array or JSONL)")
    ap.add_argument("--out_root", required=True,
                    help="Root under which preprocess_ocr/ and fakesv/ are created")
    args = ap.parse_args(argv)

    out_sam = Path(args.out_root) / "preprocess_ocr" / "sam"
    out_pkl_dir = Path(args.out_root) / "fakesv" / "preprocess_ocr"
    out_sam.mkdir(parents=True, exist_ok=True)
    out_pkl_dir.mkdir(parents=True, exist_ok=True)

    features = build_phrase_features(load_records(Path(args.data_path)))
    for vid, toks in features["phrase_sets"].items():
        digest = hashlib.md5(" ".join(sorted(toks)).encode("utf-8")).hexdigest()
        (out_sam / f"{vid}.mask.txt").write_text(digest, encoding="utf-8")
    out_pkl = out_pkl_dir / "ocr_phrase_fea.pkl"
    save_phrase_features(features, str(out_pkl))

    print("Wrote:")
    print(" -", out_sam)
    print(" -", out_pkl)


if __name__ == "__main__":
    main()
