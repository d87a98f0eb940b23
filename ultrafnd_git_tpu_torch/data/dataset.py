"""FakeSV metadata dataset (counterpart of `data/dataset.py:23-82`).

`data_complete.json` is read as one JSON array or as JSONL, after a BOM
and any leading whitespace. Labels follow the v2 convention: 假 / fake ->
1, 辟谣 / true / real -> 0, anything else 0. The augmentation helpers
(`:88-125`) are numpy on the host, as there: the same draws from the same
generator give the same results.
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

    # ------------------------------------------------------------------
    # Light augmentation helpers (host numpy)
    # ------------------------------------------------------------------
    @staticmethod
    def augment_audio(audio: np.ndarray, rng: np.random.Generator | None = None) -> np.ndarray:
        rng = rng or np.random.default_rng()
        noise_factor = rng.uniform(0.005, 0.05)
        return audio + noise_factor * rng.standard_normal(len(audio))

    @staticmethod
    def augment_video(video: np.ndarray, rng: np.random.Generator | None = None) -> np.ndarray:
        """Random horizontal flip, then a random rotation by k * 90 degrees,
        of the (H, W) plane of every frame of a (T, H, W, C) clip (of the
        image itself for a single frame)."""
        rng = rng or np.random.default_rng()
        spatial = video.ndim >= 4  # (T, H, W, C) clip vs single frame
        if rng.random() < 0.5:
            video = np.flip(video, axis=2 if spatial else 1)
        if rng.random() < 0.5:
            video = np.rot90(video, k=int(rng.choice([1, 2, 3])),
                             axes=(1, 2) if spatial else (0, 1))
        return video

    @staticmethod
    def augment_text(text: str, rng: np.random.Generator | None = None) -> str:
        rng = rng or np.random.default_rng()
        words = text.split()
        if len(words) > 2:
            words[int(rng.integers(0, len(words)))] = "random"
        return " ".join(words)
