"""The synthetic training corpus of a configuration, in the feature cache's
contract (what `ForensicTrainer(cfg, cache=...)` takes), made on the host
from the seed in a few numpy calls.

Features standard normal, aux uniform, labels uniform over {0, 1}; the
tower's token ids uniform over 1..vocab-1 with lengths uniform over
1..ids_len; each OCR set holds `ocr_tokens` distinct tokens of an
`ocr_vocab` vocabulary, `ocr_topic_tokens` of them from the pool of one of
`ocr_topics` topics, so that records of a topic share tokens and the
OCR-Jaccard graph has edges. The split is a seeded permutation cut at the
configuration's shares."""
from __future__ import annotations

from typing import Any, Dict

import numpy as np


def make_corpus(cfg: Dict[str, Any], seed: int) -> Dict[str, Any]:
    c, vocab_size = cfg["corpus"], cfg["tower"]["vocab_size"]
    rng = np.random.default_rng(seed)
    n, length = c["n"], c["ids_len"]
    out: Dict[str, Any] = {"ids": np.array([f"v{i}" for i in range(n)], dtype=object),
                           "labels": rng.integers(0, 2, size=n).astype(np.int64)}
    for key in ("text", "audio", "visual", "temporal"):
        out[key] = rng.standard_normal((n, c[key]), dtype=np.float32)
    out["aux"] = rng.uniform(size=(n, c["aux"])).astype(np.float32)
    lengths = rng.integers(1, length + 1, size=n)
    out["text_ids"] = rng.integers(1, vocab_size, size=(n, length)).astype(np.int32)
    out["text_mask"] = (np.arange(length)[None] < lengths[:, None]).astype(np.float32)
    pools = np.argsort(rng.random((c["ocr_topics"], c["ocr_vocab"])), axis=1)[:, :c["ocr_topic_pool"]]
    topic = rng.integers(0, c["ocr_topics"], size=n)
    picks = np.argsort(rng.random((n, c["ocr_topic_pool"])), axis=1)[:, :c["ocr_topic_tokens"]]
    from_topic = np.take_along_axis(pools[topic], picks, axis=1)
    spare = c["ocr_tokens"] - c["ocr_topic_tokens"]
    sets = []
    for i in range(n):
        toks = set(from_topic[i].tolist())
        while len(toks) < c["ocr_topic_tokens"] + spare:
            toks.add(int(rng.integers(0, c["ocr_vocab"])))
        sets.append({f"tok{t}" for t in toks})
    out["ocr_sets"] = sets
    order = rng.permutation(n)
    k1 = int(c["split"][0] * n)
    k2 = int((c["split"][0] + c["split"][1]) * n)
    out["split"] = (order[:k1], order[k1:k2], order[k2:])
    return out
