"""OCR token sets of records (the nodes' keys in the Jaccard graph) and the
OCR phrase pickle.

The port's copy of `ultrafnd_git_tpu/data/ocr.py`: the regex tokenizer of
the phrase pickle (`[\\w一-龥]+`, tokens of length >= 2), the trainer's
whitespace tokenizer, the pickle's builder, writer and reader
({"phrase_sets": {vid: set}, "freqs": {vid: {tok: n}}};
`generate_ocr_phrase_features.py` is its CLI), and `ocr_sets_for_records`,
which prefers the pickle's sets where it has the record.
"""
from __future__ import annotations

import pickle
import re
from collections import Counter
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Set

_TOKEN_RE = re.compile(r"[\w一-龥]+")


def clean_tokens(text: str) -> List[str]:
    """Regex tokens (word characters and CJK), length >= 2."""
    return [t for t in _TOKEN_RE.findall(text or "") if len(t) >= 2]


def whitespace_tokens(text: str) -> Set[str]:
    """Whitespace split, tokens of length >= 2."""
    out: Set[str] = set()
    for tok in (text or "").replace("\t", " ").replace("\n", " ").split():
        tok = tok.strip()
        if len(tok) >= 2:
            out.add(tok)
    return out


def build_phrase_features(records: Sequence[Dict]) -> Dict[str, Dict]:
    """The phrase-feature structure keyed by video id: each record's regex
    token set and token counts."""
    phrase_sets: Dict[str, Set[str]] = {}
    freqs: Dict[str, Dict[str, int]] = {}
    for i, rec in enumerate(records):
        vid = rec.get("video_id") or rec.get("id") or f"rec_{i}"
        toks = clean_tokens(rec.get("ocr") or "")
        phrase_sets[vid] = set(toks)
        freqs[vid] = dict(Counter(toks))
    return {"phrase_sets": phrase_sets, "freqs": freqs}


def save_phrase_features(features: Dict, path: str) -> None:
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as fh:
        pickle.dump(features, fh)


def load_phrase_features(path: str) -> Optional[Dict]:
    """The OCR phrase pickle, or None when it is missing or not one."""
    try:
        with open(path, "rb") as fh:
            data = pickle.load(fh)
        if isinstance(data, dict) and "phrase_sets" in data:
            return data
    except Exception:  # an unreadable pickle counts as absent, as in the original
        pass
    return None


def ocr_sets_for_records(
    records: Sequence[Dict],
    ocr_phrase_pkl: Optional[str] = None,
    clean_fallback: Optional[bool] = None,
) -> List[Set[str]]:
    """Per-record OCR token sets, from the phrase pickle where it has the
    record.

    `clean_fallback` says how records absent from the pickle are
    tokenized: the regex `clean_tokens` (the pickle's own tokenization) or
    the whitespace split. None means clean exactly when a pickle was
    loaded, so that one corpus never mixes the two vocabularies. Serving
    passes True when the checkpoint was trained with a pickle.
    """
    pkl = load_phrase_features(ocr_phrase_pkl) if ocr_phrase_pkl else None
    if clean_fallback is None:
        clean_fallback = pkl is not None
    sets: List[Set[str]] = []
    for i, rec in enumerate(records):
        vid = rec.get("video_id") or rec.get("id") or f"rec_{i}"
        if pkl is not None and vid in pkl["phrase_sets"]:
            sets.append(set(pkl["phrase_sets"][vid]))
        elif clean_fallback:
            sets.append(set(clean_tokens(rec.get("ocr") or "")))
        else:
            sets.append(whitespace_tokens(rec.get("ocr") or ""))
    return sets
