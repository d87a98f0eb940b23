"""Feature-cache npz reader and writer (counterpart of `data/cache.py:448-538`).

The file format is the JAX package's `feature_cache.npz` (cache version 3):
per-row arrays plus `ocr_sets` stored as JSON strings of sorted tokens.
"""
from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Any, Dict, List

import numpy as np

# Sensational-term lexicon for the emotion-intensity proxy.
EMO_TERMS = ("恐惧", "警告", "危险", "外星", "消失", "危机", "谣言", "假")

CACHE_VERSION = 3
FEATURES_VERSION = 3
TOWER_IDS_LEN = 64  # tokens kept per record for the tower
TOWER_VOCAB = 32768  # stable-hash vocabulary


def load_cache(path: str) -> Dict[str, Any]:
    """Read a cache written by the JAX package (or `save_cache`).

    Raises FileNotFoundError when absent and ValueError for a version this
    reader does not know; a v2 cache (no token ids) loads with zero ids.
    """
    p = Path(path)
    if not p.exists():
        raise FileNotFoundError(f"no feature cache at {p}")
    with np.load(p, allow_pickle=False) as z:
        version = int(z["version"])
        if version not in (2, CACHE_VERSION):
            raise ValueError(f"cache at {p} has unknown version {version}")
        n = z["labels"].shape[0]
        ocr_sets: List[set] = [set(json.loads(s)) for s in z["ocr_sets"]]
        return {
            "ids": np.array(list(z["ids"]), dtype=object),
            "labels": z["labels"],
            "text": z["text"],
            "audio": z["audio"],
            "visual": z["visual"],
            "temporal": z["temporal"],
            "aux": z["aux"],
            "evidence": z["evidence"],
            "text_ids": (
                z["text_ids"] if "text_ids" in z
                else np.zeros((n, TOWER_IDS_LEN), np.int32)
            ),
            "text_mask": (
                z["text_mask"] if "text_mask" in z
                else np.zeros((n, TOWER_IDS_LEN), np.float32)
            ),
            "ocr_sets": ocr_sets,
            "split": (z["split_train"], z["split_val"], z["split_test"]),
        }


def save_cache(cache: Dict[str, Any], path: str) -> None:
    """Write `cache` in the same npz format, atomically (tmp + rename)."""
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    tmp = p.with_name(f".{p.name}.tmp-{os.getpid()}.npz")
    n = len(cache["labels"])
    tr, va, te = cache["split"]
    np.savez_compressed(
        tmp,
        version=np.int64(CACHE_VERSION),
        features_version=np.int64(FEATURES_VERSION),
        fingerprint=np.str_(""),
        ids=np.array([str(x) for x in cache["ids"]]),
        labels=cache["labels"],
        text=cache["text"],
        audio=cache["audio"],
        visual=cache["visual"],
        temporal=cache["temporal"],
        aux=cache["aux"],
        evidence=cache.get("evidence", np.zeros((n, 3), np.float32)),
        text_ids=cache["text_ids"],
        text_mask=cache["text_mask"],
        ocr_sets=np.array(
            [json.dumps(sorted(s), ensure_ascii=False) for s in cache["ocr_sets"]]
        ),
        split_train=tr,
        split_val=va,
        split_test=te,
    )
    os.replace(tmp, p)
