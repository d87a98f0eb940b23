"""FakeSV metadata dataset (counterpart of `data/dataset.py:23-82`).

`data_complete.json` is read as one JSON array or as JSONL, after a BOM
and any leading whitespace. Labels follow the v2 convention: 假 / fake ->
1, 辟谣 / true / real -> 0, anything else 0. The augmentation helpers of
the raw-media path are not ported (ROADMAP.md).
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, List

import numpy as np

FAKE_LABELS = ("假", "fake")
REAL_LABELS = ("辟谣", "true", "real")


def label_of(record: Dict[str, Any]) -> int:
    ann = (record.get("annotation") or "").strip()
    if ann in FAKE_LABELS:
        return 1
    return 0


class FakeSVRawDataset:
    """Metadata wrapper over a FakeSV-style data root: `data_root` must hold
    `data_complete.json` (FileNotFoundError otherwise)."""

    def __init__(self, data_root: str):
        self.root = Path(data_root)
        self.json_path = self.root / "data_complete.json"
        if not self.json_path.exists():
            raise FileNotFoundError(f"data_complete.json not found at {self.json_path}")
        with open(self.json_path, "r", encoding="utf-8-sig") as fh:
            text = fh.read()  # universal newlines: "\r\n" and "\r" read as "\n"
        if text.lstrip().startswith("["):
            self.records: List[Dict[str, Any]] = json.loads(text)
        else:
            # lines split on "\n" only, as iterating the file does (str.splitlines
            # would also split inside a record at U+2028 and the like)
            self.records = [json.loads(ln) for ln in text.split("\n") if ln.strip()]
        self.labels = np.array([label_of(r) for r in self.records], dtype=np.int64)

    def __len__(self) -> int:
        return len(self.records)

    def get_item(self, idx: int) -> Dict[str, Any]:
        r = self.records[idx]
        comments = r.get("comments") or []
        if isinstance(comments, str):
            comments = [comments]
        return {
            "id": r.get("video_id") or f"rec_{idx}",
            "title": r.get("title") or "",
            "ocr": r.get("ocr") or "",
            "comments": comments,
            "label": int(self.labels[idx]),
        }
