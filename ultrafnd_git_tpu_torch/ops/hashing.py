"""Stable hash embeddings: 64-bit FNV-1a over UTF-8 bytes.

The port's own copy of `ultrafnd_git_tpu/ops/hashing.py`, reduced to what
the port calls: the salted FNV-1a hash, the process-wide featurization
salt, `hash_embed_batch` and `token_vocabulary`. The salt here is this
package's own process state; it does not follow the JAX package's.

FNV-1a is stable across processes, hosts and Python versions, so cached
features and tests agree. A salt re-draws every hash featurization (bag
of tokens, tower token ids); by FNV's prefix property, continuing from
fnv1a(salt) equals hashing salt||token in one pass. OCR token sets, and so
the Jaccard graph, are raw strings and never move with the salt.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np

_FNV_OFFSET = 0xCBF29CE484222325
_FNV_PRIME = 0x100000001B3
_MASK64 = 0xFFFFFFFFFFFFFFFF

_SALT = ""
_BASIS = _FNV_OFFSET


def _fnv1a_64_raw(token: str, basis: int) -> int:
    h = basis
    for b in token.encode("utf-8"):
        h ^= b
        h = (h * _FNV_PRIME) & _MASK64
    return h


def set_hash_salt(salt: str) -> None:
    """Set the process-wide featurization salt ("" = canonical draw).

    Set it before featurizing (the Predictor does, from the checkpoint
    cfg); features built under different salts never mix.
    """
    global _SALT, _BASIS
    salt = salt or ""
    if salt == _SALT:
        return
    _SALT = salt
    _BASIS = _fnv1a_64_raw(salt, _FNV_OFFSET) if salt else _FNV_OFFSET
    _CACHE.clear()


def get_hash_salt() -> str:
    return _SALT


def get_hash_basis() -> int:
    """FNV starting state of the process-wide draw (see set_hash_salt)."""
    return _BASIS


def basis_for_salt(salt: str) -> int:
    """FNV starting state for an explicit salt, independent of the
    process-wide one (a tower pinned to its own draw)."""
    return _fnv1a_64_raw(salt, _FNV_OFFSET) if salt else _FNV_OFFSET


def fnv1a_64(token: str, basis: Optional[int] = None) -> int:
    """64-bit FNV-1a of a string's UTF-8 bytes, under the process-wide salt
    or an explicit `basis` (`basis_for_salt`)."""
    return _fnv1a_64_raw(token, _BASIS if basis is None else basis)


class _TokenHashCache:
    """Memoized token -> hash, bounded: a serving process sees an unbounded
    stream of tokens, so the memo resets at its cap (FNV is cheap)."""

    MAX_ENTRIES = 1 << 20

    def __init__(self) -> None:
        self._raw: Dict[str, int] = {}

    def bucket(self, token: str, dim: int) -> int:
        h = self._raw.get(token)
        if h is None:
            if len(self._raw) >= self.MAX_ENTRIES:
                self._raw.clear()
            h = fnv1a_64(token)
            self._raw[token] = h
        return h % dim

    def clear(self) -> None:
        self._raw.clear()


_CACHE = _TokenHashCache()


def hash_embed_batch(
    texts: Sequence[str], dim: int, max_tokens: int | None = None
) -> np.ndarray:
    """(N, dim) f32 bag-of-hashed-tokens embeddings, rows L2-normalised.

    Whitespace tokens (the first `max_tokens` when given), +1 per token at
    fnv1a % dim, norm + 1e-9; empty texts stay zero. The native C++ path
    (`native/hashops.cpp`) when it builds, else the numpy path below. The
    two agree within one ulp: the C++ path multiplies by a float64
    reciprocal of the norm, the numpy path divides in float32.
    """
    from ultrafnd_git_tpu_torch import native  # here: native imports this module

    native_out = native.hash_embed_batch_native(texts, dim, max_tokens, basis=_BASIS)
    if native_out is not None:
        return native_out

    out = np.zeros((len(texts), dim), dtype=np.float32)
    rows: List[int] = []
    cols: List[int] = []
    for i, text in enumerate(texts):
        if not text:
            continue
        toks = text.split()
        if max_tokens is not None:
            toks = toks[:max_tokens]
        for tok in toks:
            rows.append(i)
            cols.append(_CACHE.bucket(tok, dim))
    if rows:
        np.add.at(out, (np.asarray(rows), np.asarray(cols)), 1.0)
        norms = np.linalg.norm(out, axis=1, keepdims=True)
        np.divide(out, norms + 1e-9, out=out, where=norms > 0)
    return out.astype(np.float32)


def token_vocabulary(token_sets: Iterable[Iterable[str]]) -> Dict[str, int]:
    """Consecutive ids for the unique tokens, in first-seen order."""
    vocab: Dict[str, int] = {}
    for toks in token_sets:
        for t in toks:
            if t not in vocab:
                vocab[t] = len(vocab)
    return vocab
