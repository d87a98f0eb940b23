"""The general generator of text-encoding traffic: requests of token-id
strings, read from a traffic file's parameters.

A request holds `records` records; each field of a record appears with
probability `p`, `count` times (uniform over [lo, hi]), each a string of
`tokens` tokens (uniform over [lo, hi], [CLS] and [SEP] included, at most
the ladder's max_length), flattened record by record, field by field. The
request's strings are padded to its longest (a tokenizer's padding=True).

The sizes come from `sizes_seed`, fixed in the traffic file, so every run
draws the same pool of `pool` requests and every seed does the same work;
`--seed` orders the pool and draws the token ids, uniform over the
configuration's word range. A pool about as large as the requests a window
finishes is walked about once a run, so that runs of different seeds
differ in the order of the work and not in how much of each size there is."""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np


def request_lengths(traffic: Dict[str, Any], max_length: int) -> List[np.ndarray]:
    """The pool's requests, each the lengths of its strings."""
    rng = np.random.default_rng(traffic["sizes_seed"])
    pool = []
    for _ in range(traffic["pool"]):
        lengths: List[int] = []
        for _ in range(traffic["records"]):
            for field in traffic["fields"]:
                if rng.random() >= field["p"]:
                    continue
                count = int(rng.integers(field["count"][0], field["count"][1] + 1))
                lo, hi = field["tokens"]
                lengths += [min(int(x), max_length) for x in rng.integers(lo, hi + 1, size=count)]
        pool.append(np.asarray(lengths, dtype=np.int64))
    return pool


def make_requests(traffic: Dict[str, Any], cfg: Dict[str, Any], seed: int) -> List[Dict[str, Any]]:
    """[{"ids" (n, L) int64, "mask" (n, L) f32, "lengths" (n,)}] in the
    seed's order. L is the request's longest string."""
    tok = cfg["tokens"]
    pool = request_lengths(traffic, cfg["ladder"]["max_length"])
    rng = np.random.default_rng(seed)
    out = []
    for k in rng.permutation(len(pool)):
        lengths = pool[k]
        n, width = len(lengths), int(lengths.max())
        ids = rng.integers(tok["first_word"], cfg["vocab_size"], size=(n, width))
        mask = (np.arange(width)[None] < lengths[:, None])
        ids[:, 0] = tok["cls"]
        ids[np.arange(n), lengths - 1] = tok["sep"]
        ids[~mask] = tok["pad"]
        out.append({"ids": ids.astype(np.int64), "mask": mask.astype(np.float32),
                    "lengths": lengths})
    return out
