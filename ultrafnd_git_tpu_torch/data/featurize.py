"""Request featurizer: the cache build over raw request records.

What the JAX `Predictor.featurize` runs: under fused-align serving
`build_feature_cache(..., with_align=False)`, the host half, with the hash
rungs of the encoders (the text ladder's tower under
`ULTRAFND_TEXT_DEVICE=1`, on the device the encoders give it) and, for an
evidence checkpoint, the two host
evidence columns (alignment, delay, aux and the evidence delay column are
computed by the scoring program); on the legacy two-dispatch path
`with_align=True`, the full cache, whose align pass runs on the encoders'
device.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

from ultrafnd_git_tpu_torch.data.cache import build_feature_cache, make_encoders


class _Records:
    """Raw request records as `build_feature_cache`'s dataset (label 0; ids from
    video_id, id, else q_<offset + i>)."""

    def __init__(self, records: Sequence[Dict[str, Any]], id_offset: int):
        self._recs = [
            {
                "id": r.get("video_id") or r.get("id") or f"q_{id_offset + i}",
                "title": r.get("title") or "",
                "ocr": r.get("ocr") or "",
                "comments": list(r.get("comments") or []),
                "label": 0,
            }
            for i, r in enumerate(records)
        ]

    def __len__(self) -> int:
        return len(self._recs)

    def get_item(self, i: int) -> Dict[str, Any]:
        return self._recs[i]


def featurize_records(
    records: Sequence[Dict[str, Any]],
    id_offset: int = 0,
    with_tower_tokens: bool = True,
    ocr_clean: bool = False,
    with_evidence: bool = False,
    encoders: Optional[Dict[str, Any]] = None,
    with_align: bool = False,
) -> Dict[str, Any]:
    """Raw records (title / ocr / comments) -> the host-only feature dict:
    ids, text (N,768), audio (N,128), visual (N,512), emo (N,), ocr_sets,
    text_ids / text_mask (N,64) when `with_tower_tokens`, and evidence_host
    (N,2) when `with_evidence`. With `with_align`, the full cache instead:
    "temporal", "aux" and "evidence" in place of "emo" and
    "evidence_host", from the align MLP `encoders["tsync"]`.

    Hashing follows the port's process-wide salt (`ops.hashing.set_hash_salt`):
    the caller sets it first. `encoders` (from `make_encoders`) are built
    on the CPU when not given (the Predictors pass theirs, whose text
    ladder runs on the Predictor's device).
    """
    if encoders is None:
        encoders = make_encoders(with_evidence=with_evidence, device="cpu")
    return build_feature_cache(
        _Records(records, id_offset),
        encoders=encoders,
        ocr_clean_fallback=ocr_clean,
        with_evidence=with_evidence,
        with_tower_tokens=with_tower_tokens,
        with_align=with_align,
    )
