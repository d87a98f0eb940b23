"""Host-only request featurizer, hash rungs only.

Counterpart of what the JAX `Predictor.featurize` runs under fused-align
serving: `build_feature_cache(..., with_align=False, with_evidence=False)`
(`data/cache.py:153-282`) with the offline hash rungs of the text, audio
and visual encoders. Alignment, delay and aux are computed by the scoring
program, not here. The HuggingFace rungs are not ported.
"""
from __future__ import annotations

from typing import Any, Dict, List, Sequence

import numpy as np

from ultrafnd_git_tpu.data.ocr import ocr_sets_for_records
from ultrafnd_git_tpu.ops.hashing import hash_embed_batch
from ultrafnd_git_tpu_torch.data.cache import EMO_TERMS, TOWER_IDS_LEN, TOWER_VOCAB
from ultrafnd_git_tpu_torch.models.transformer import hash_tokenize_batch

TEXT_DIM, AUDIO_DIM, VISUAL_DIM = 768, 128, 512


def encode_fields_batch(records: Sequence[Dict], dim: int = TEXT_DIM) -> np.ndarray:
    """Mean of the hash embeddings of title, OCR and up to 10 comments,
    L2-normalised; records with no text stay zero (`models/text.py:248-280`)."""
    flat: List[str] = []
    owners: List[int] = []
    for i, rec in enumerate(records):
        parts = [
            t for t in [rec["title"], rec["ocr"], *rec["comments"][:10]] if t
        ]
        flat.extend(parts)
        owners.extend([i] * len(parts))
    n = len(records)
    out = np.zeros((n, dim), dtype=np.float32)
    if not flat:
        return out
    vecs = hash_embed_batch(flat, dim)
    counts = np.zeros((n, 1), dtype=np.float32)
    np.add.at(out, np.asarray(owners), vecs)
    np.add.at(counts, (np.asarray(owners), np.zeros(len(owners), int)), 1.0)
    np.divide(out, counts, out=out, where=counts > 0)
    norms = np.linalg.norm(out, axis=-1, keepdims=True)
    np.divide(out, norms + 1e-9, out=out, where=norms > 0)
    return out.astype(np.float32)


def _l2n_rows(x: np.ndarray) -> np.ndarray:
    n = np.linalg.norm(x, axis=-1, keepdims=True)
    return (x / (n + 1e-9)).astype(np.float32)


def featurize_records(
    records: Sequence[Dict[str, Any]],
    id_offset: int = 0,
    with_tower_tokens: bool = True,
    ocr_clean: bool = False,
) -> Dict[str, Any]:
    """Raw records (title / ocr / comments) -> the host-only feature dict:
    ids, text (N,768), audio (N,128), visual (N,512), emo (N,), ocr_sets,
    and text_ids / text_mask (N,64) when `with_tower_tokens`.

    Hashing follows the process-wide salt: the caller sets it first.
    """
    recs = [
        {
            "id": r.get("video_id") or r.get("id") or f"q_{id_offset + i}",
            "title": r.get("title") or "",
            "ocr": r.get("ocr") or "",
            "comments": list(r.get("comments") or []),
        }
        for i, r in enumerate(records)
    ]
    out: Dict[str, Any] = {
        "ids": np.array([r["id"] for r in recs], dtype=object),
        "text": encode_fields_batch(recs),
    }
    if with_tower_tokens:
        combined = [
            " ".join([r["title"], r["ocr"], *r["comments"][:10]]).strip()
            for r in recs
        ]
        out["text_ids"], out["text_mask"] = hash_tokenize_batch(
            combined, TOWER_IDS_LEN, TOWER_VOCAB
        )
    audio_proxies = [
        r["title"] + " " + (" ".join(r["comments"][:1]) if r["comments"] else "")
        for r in recs
    ]
    out["audio"] = hash_embed_batch(audio_proxies, AUDIO_DIM, max_tokens=AUDIO_DIM)
    # visual = flow proxy ++ ELA proxy, L2-normalised. Both hash rungs embed
    # the same proxy string at width 256, so the two halves are one array,
    # and 256 + 256 already fits the 512 contract.
    vis_proxies = [r["ocr"] or r["title"] for r in recs]
    half = VISUAL_DIM // 2
    proxy = hash_embed_batch(vis_proxies, half, max_tokens=half)
    out["visual"] = _l2n_rows(np.concatenate([proxy, proxy], axis=1))
    out["emo"] = np.array(
        [
            min(1.0, 0.1 * sum(term in (r["title"] + r["ocr"]) for term in EMO_TERMS))
            for r in recs
        ],
        dtype=np.float32,
    )
    out["ocr_sets"] = ocr_sets_for_records(recs, None, clean_fallback=ocr_clean)
    return out
