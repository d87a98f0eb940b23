"""Feature-cache npz reader and writer (counterpart of `data/cache.py:448-538`)
and the trainer's cache ladder (`bootstrap_cache`, `data/cache.py:343-389`).

The file format is the JAX package's `feature_cache.npz` (cache version 3):
per-row arrays plus `ocr_sets` stored as JSON strings of sorted tokens.
"""
from __future__ import annotations

import json
import os
import shutil
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

# Sensational-term lexicon for the emotion-intensity proxy.
EMO_TERMS = ("恐惧", "警告", "危险", "外星", "消失", "危机", "谣言", "假")

CACHE_VERSION = 3
FEATURES_VERSION = 3
TOWER_IDS_LEN = 64  # tokens kept per record for the tower
TOWER_VOCAB = 32768  # stable-hash vocabulary


def _fingerprint_features(fp: str) -> Optional[int]:
    """The feature-code version a JSON fingerprint carries ('features',
    absent = v1); None for a non-JSON one ('injected', pre-fingerprint
    empty), as `_parse_fingerprint` of the JAX package reads it."""
    try:
        d = json.loads(fp)
    except ValueError:
        return None
    return int(d.get("features", 1)) if isinstance(d, dict) else None


def load_cache(path: str, stale_features: str = "rebuild") -> Dict[str, Any]:
    """Read a cache written by the JAX package (or `save_cache`).

    Raises FileNotFoundError when absent and ValueError for a version this
    reader does not know; a v2 cache (no token ids) loads with zero ids.
    A cache built by other feature code (its `features_version`, else the
    version in its fingerprint) is decided as the JAX loader decides it
    (`data/cache.py:496-511`): with `stale_features="reuse"` (a checkpoint
    in the run's out_dir was trained on it) it loads with the JAX warning;
    otherwise the JAX loader rebuilds it, which the port cannot, so it
    raises NotImplementedError.
    """
    p = Path(path)
    if not p.exists():
        raise FileNotFoundError(f"no feature cache at {p}")
    with np.load(p, allow_pickle=False) as z:
        version = int(z["version"])
        if version not in (2, CACHE_VERSION):
            raise ValueError(f"cache at {p} has unknown version {version}")
        if version == 2:
            print(f"note: cache at {p} is v2 (no token ids); "
                  "--train_text_tower needs a rebuilt cache")
        stored_feat = _fingerprint_features(str(z["fingerprint"]) if "fingerprint" in z else "")
        if "features_version" in z:
            stored_feat = int(z["features_version"])
        if stored_feat is not None and stored_feat != FEATURES_VERSION:
            if stale_features != "reuse":
                raise NotImplementedError(
                    f"cache at {p} was built by older feature code (v{stored_feat}, "
                    f"current v{FEATURES_VERSION}) and the JAX trainer would rebuild "
                    "it; building a feature cache is not ported to "
                    "ultrafnd_git_tpu_torch yet (see the port's module list in "
                    "ROADMAP.md)"
                )
            print(
                f"⚠️  cache at {p} was built by older feature code "
                f"(v{stored_feat}, current v{FEATURES_VERSION}); "
                "reusing it because the checkpoint in this out_dir "
                "was trained on exactly these features. NOTE: serving "
                "featurizes NEW records with current code — delete "
                "feature_cache.npz and retrain to refresh"
            )
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


def bootstrap_cache(
    out_dir: str,
    model_dir: Optional[str] = None,
    cache: Optional[Dict[str, Any]] = None,
    cache_to_disk: bool = True,
    reuse_stale_features: bool = False,
) -> Tuple[Dict[str, Any], str]:
    """The trainer's feature cache and where it came from ("injected",
    "out_dir" or "model_dir"): injected > `<out_dir>/feature_cache.npz` >
    `<model_dir>/feature_cache.npz` (a model directory written by
    `scripts/export_torch_model.py`, copied byte for byte into out_dir so
    the run's checkpoints travel with their cache, fingerprint and feature
    version included). `reuse_stale_features` (eval_only, resume) is
    `load_cache`'s `stale_features="reuse"` for out_dir's own cache, the
    one a checkpoint there was trained on.

    Building a cache from a raw data_root is not ported: its align MLP is a
    `jax.random.PRNGKey(seed)` draw (`models/temporal.py:140`) that torch
    cannot repeat, so it raises NotImplementedError (see ROADMAP.md).
    """
    own = Path(out_dir) / "feature_cache.npz"
    if cache is not None:
        if cache_to_disk and not own.exists():
            save_cache(cache, str(own))
        return cache, "injected"
    if own.exists():
        return load_cache(str(own), "reuse" if reuse_stale_features else "rebuild"), "out_dir"
    src = Path(model_dir) / "feature_cache.npz" if model_dir is not None else None
    if src is not None and src.exists():
        cache = load_cache(str(src))  # no checkpoint of out_dir was trained on it
        if cache_to_disk:
            own.parent.mkdir(parents=True, exist_ok=True)
            tmp = own.with_name(f".{own.name}.tmp-{os.getpid()}.npz")
            shutil.copyfile(src, tmp)
            os.replace(tmp, own)  # readers see old-or-complete, never partial
        return cache, "model_dir"
    raise NotImplementedError(
        f"no feature_cache.npz in {out_dir}"
        + (f" or {model_dir}" if model_dir else "")
        + ": building a feature cache from a raw data_root is not ported to "
        "ultrafnd_git_tpu_torch yet (see the port's module list in "
        "ROADMAP.md); pass --model_dir from scripts/export_torch_model.py"
    )
