"""Host C++ ops bound with ctypes: hash embeddings, FNV-1a, the Jaccard
graph (dense adjacency and edge list).

The port's copy of `ultrafnd_git_tpu/native/`, reduced to the bindings
the port calls. Each source (`hashops.cpp`, `graphops.cpp`) is built with
g++ -O3 at first use into `build/torch_native/` at the repository root,
keyed by a hash of the source, and loaded with ctypes. Where no toolchain
is found, or `ULTRAFND_NATIVE=0` is set, each binding returns None and
its caller takes the numpy path: the same bits for the Jaccard adjacency,
within one ulp for the hash embeddings (see `ops.hashing`). These are
host ops: nothing here runs on the GPU.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from ultrafnd_git_tpu_torch.ops.hashing import get_hash_basis, token_vocabulary

_HERE = Path(__file__).resolve().parent
BUILD_DIR = _HERE.parents[1] / "build" / "torch_native"
_FNV_OFFSET = 0xCBF29CE484222325

_LIBS: Dict[str, Optional[ctypes.CDLL]] = {}

_U8P = ctypes.POINTER(ctypes.c_uint8)
_I32P = ctypes.POINTER(ctypes.c_int32)
_I64P = ctypes.POINTER(ctypes.c_int64)
_F32P = ctypes.POINTER(ctypes.c_float)
_SIGNATURES = {
    "hashops": {
        "ufnd_fnv1a64_basis": (ctypes.c_uint64, [_U8P, ctypes.c_int64, ctypes.c_uint64]),
        "ufnd_hash_embed_batch_basis": (None, [_U8P, _I64P, ctypes.c_int64, ctypes.c_int64,
                                               ctypes.c_int64, ctypes.c_uint64, _F32P]),
    },
    "graphops": {
        "ufnd_jaccard_adj": (None, [_I64P, _I32P, ctypes.c_int64, ctypes.c_int64,
                                    ctypes.c_float, ctypes.c_int, _F32P]),
        "ufnd_jaccard_edges": (ctypes.c_int64, [_I64P, _I32P, ctypes.c_int64, ctypes.c_int64,
                                                ctypes.c_float, ctypes.c_int, ctypes.c_int64,
                                                _I32P, _I32P, _F32P]),
    },
}


def _build(name: str) -> Optional[ctypes.CDLL]:
    src = _HERE / f"{name}.cpp"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    so_path = BUILD_DIR / f"{name}_{digest}.so"
    if not so_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so_path.with_suffix(f".build{os.getpid()}.so")
        cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", str(src), "-o", str(tmp)]
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
            os.replace(tmp, so_path)  # a concurrent build never loads a partial file
        except (OSError, subprocess.SubprocessError):
            tmp.unlink(missing_ok=True)
            return None
    try:
        lib = ctypes.CDLL(str(so_path))
    except OSError:
        return None
    for fn, (restype, argtypes) in _SIGNATURES[name].items():
        getattr(lib, fn).restype = restype
        getattr(lib, fn).argtypes = argtypes
    return lib


def get_lib(name: str) -> Optional[ctypes.CDLL]:
    """The loaded `name` library ("hashops" or "graphops"), or None when
    disabled (`ULTRAFND_NATIVE=0`) or not buildable."""
    if os.environ.get("ULTRAFND_NATIVE", "1") == "0":
        return None
    if name not in _LIBS:
        _LIBS[name] = _build(name)
    return _LIBS[name]


def reset() -> None:
    """Forget the loaded libraries (tests switch the native path on and off)."""
    _LIBS.clear()


def fnv1a_64_native(token: str, basis: Optional[int] = None) -> Optional[int]:
    """FNV-1a in C++, as `ops.hashing.fnv1a_64`; `basis=None` follows the
    port's process-wide salt. None when the library is absent."""
    lib = get_lib("hashops")
    if lib is None:
        return None
    if basis is None:
        basis = get_hash_basis()
    data = token.encode("utf-8")
    buf = (ctypes.c_uint8 * max(1, len(data))).from_buffer_copy(data or b"\x00")
    return int(lib.ufnd_fnv1a64_basis(buf, len(data), ctypes.c_uint64(basis)))


def hash_embed_batch_native(
    texts: Sequence[str],
    dim: int,
    max_tokens: Optional[int] = None,
    basis: int = _FNV_OFFSET,
) -> Optional[np.ndarray]:
    """Batched hash embedding in C++ under FNV start `basis`; None when the
    library is absent."""
    lib = get_lib("hashops")
    if lib is None:
        return None
    encoded = [(t or "").encode("utf-8") for t in texts]
    offsets = np.zeros(len(encoded) + 1, dtype=np.int64)
    np.cumsum([len(e) for e in encoded], out=offsets[1:])
    buf = np.frombuffer(b"".join(encoded) or b"\x00", dtype=np.uint8).copy()
    out = np.zeros((len(encoded), dim), dtype=np.float32)
    lib.ufnd_hash_embed_batch_basis(
        buf.ctypes.data_as(_U8P), offsets.ctypes.data_as(_I64P), len(encoded), dim,
        -1 if max_tokens is None else int(max_tokens), ctypes.c_uint64(basis),
        out.ctypes.data_as(_F32P),
    )
    return out


def jaccard_adj_native(ocr_sets: Sequence, thresh: float, mode: int) -> Optional[np.ndarray]:
    """Dense (N, N) f32 OCR-Jaccard adjacency in C++ (mode 0: binary >=
    thresh, diagonal 1; mode 2: full pairwise Jaccard). None when the
    library is absent, or for mode 0 with thresh <= 0, where the numpy
    semantics link even pairs that share no token."""
    lib = get_lib("graphops")
    if lib is None or (mode == 0 and thresh <= 0.0):
        return None
    n = len(ocr_sets)
    out = np.zeros((n, n), dtype=np.float32)
    if n == 0:
        return out
    row_off, tok, vocab_n = _csr_from_sets(ocr_sets)
    lib.ufnd_jaccard_adj(
        row_off.ctypes.data_as(_I64P), tok.ctypes.data_as(_I32P), n, vocab_n,
        ctypes.c_float(float(thresh)), int(mode), out.ctypes.data_as(_F32P),
    )
    return out


def jaccard_edges_native(
    ocr_sets: Sequence, thresh: float, mode: int = 0
) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Symmetric COO edge list (src, dst, w) in C++, both directions, no
    diagonal, sorted by (src, dst); mode 0 weighs every edge 1, mode 1 by
    its Jaccard value. None when the library is absent, or for mode 0 with
    thresh <= 0 (see `jaccard_adj_native`).

    Two passes: count, allocate exactly, fill. Raises RuntimeError when the
    fill writes another count than the first pass gave (a check that
    `python -O` keeps)."""
    lib = get_lib("graphops")
    if lib is None or (mode == 0 and thresh <= 0.0):
        return None
    n = len(ocr_sets)
    src = np.zeros(0, np.int32)
    dst = np.zeros(0, np.int32)
    w = np.zeros(0, np.float32)
    if n == 0:
        return src, dst, w
    row_off, tok, vocab_n = _csr_from_sets(ocr_sets)
    args = (row_off.ctypes.data_as(_I64P), tok.ctypes.data_as(_I32P), n, vocab_n,
            ctypes.c_float(float(thresh)), int(mode))
    total = int(lib.ufnd_jaccard_edges(*args, 0, None, None, None))
    if total:
        src = np.empty(total, np.int32)
        dst = np.empty(total, np.int32)
        w = np.empty(total, np.float32)
        wrote = int(lib.ufnd_jaccard_edges(*args, total, src.ctypes.data_as(_I32P),
                                           dst.ctypes.data_as(_I32P), w.ctypes.data_as(_F32P)))
        if wrote != total:
            raise RuntimeError(
                f"ufnd_jaccard_edges counted {total} entries but the fill pass gave {wrote}"
            )
        order = np.lexsort((dst, src))
        src, dst, w = src[order], dst[order], w[order]
    return src, dst, w


def _csr_from_sets(ocr_sets: Sequence):
    """(row_off int64[n+1], tok int32[nnz], vocab_size) from token sets."""
    vocab = token_vocabulary(ocr_sets)
    row_off = np.zeros(len(ocr_sets) + 1, dtype=np.int64)
    np.cumsum([len(s) for s in ocr_sets], out=row_off[1:])
    tok = np.fromiter((vocab[t] for s in ocr_sets for t in s), dtype=np.int32,
                      count=int(row_off[-1]))
    return row_off, tok, max(1, len(vocab))
