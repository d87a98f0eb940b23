"""The feature cache: its build, npz persistence and the trainer's ladder
(counterpart of `data/cache.py:54-538`).

`build_feature_cache(raw)` makes, in batched passes over the corpus:

    ids (N,) | labels (N,) | text (N,768) | audio (N,128) | visual (N,512)
    temporal (N,256) | aux (N,2) | evidence (N,3) | text_ids, text_mask (N,64)
    ocr_sets list[set] | split (tr, va, te)

  * text = mean of the title / OCR / <= 10 comment encodings, L2-normed
    (the text ladder of `models/encoders.py`: the hash rung, HF BERT, or
    the text tower, the twins on the encoders' text device);
  * audio = encoding of the proxy `title + " " + first comment`;
  * visual = flow proxy ++ ELA proxy of the OCR (else the title), fit to
    512 and L2-normed;
  * temporal = align(text, visual) of the `TemporalSyncNet`, on the
    encoders' device (the only device pass of the build);
  * aux = [clip(1 - cos(align(T,T), align(T,V))), min(1, 0.1 * count of 8
    sensational terms)];
  * evidence = [semantic gap, emotion intensity, aux delay];
  * ocr_sets = whitespace (or phrase-pickle) tokens; split = stratified
    70/15/15 from `np.random.default_rng(seed)`.

Everything on the host is the JAX package's recipe on the port's hash
rungs, and equals it exactly. `temporal`, `aux[:, 0]` and `evidence[:, 2]`
come from the align MLP, which the port draws from a torch.Generator
(`models/temporal.TemporalSyncNet`): the port's fingerprint names that draw
(`"align_init": "torch"`), so neither package takes the other's build for
its own.

The file format is the JAX package's `feature_cache.npz` (cache version 3):
per-row arrays plus `ocr_sets` stored as JSON strings of sorted tokens.
"""
from __future__ import annotations

import json
import os
import shutil
import time
import zipfile
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ultrafnd_git_tpu_torch.data.dataset import FakeSVRawDataset
from ultrafnd_git_tpu_torch.data.ocr import ocr_sets_for_records
from ultrafnd_git_tpu_torch.data.splits import make_split
from ultrafnd_git_tpu_torch.models.affective import AffectiveForensics, emotion_rung
from ultrafnd_git_tpu_torch.models.encoders import (
    ProxyTextEncoder,
    TextFieldEncoder,
    text_rung,
)
from ultrafnd_git_tpu_torch.models.semantic import SemanticForgeryAnalyzer, clip_rung
from ultrafnd_git_tpu_torch.models.temporal import TemporalSyncNet
from ultrafnd_git_tpu_torch.models.transformer import hash_tokenize_batch
from ultrafnd_git_tpu_torch.ops.hashing import get_hash_salt
from ultrafnd_git_tpu_torch.utils.device import resolve_device

# Sensational-term lexicon for the emotion-intensity proxy.
EMO_TERMS = ("恐惧", "警告", "危险", "外星", "消失", "危机", "谣言", "假")

CACHE_VERSION = 3
FEATURES_VERSION = 3
TOWER_IDS_LEN = 64  # tokens kept per record for the tower
TOWER_VOCAB = 32768  # stable-hash vocabulary
ALIGN_INIT = "torch"  # the port's align draw, named in its fingerprint
TEXT_INIT = "torch"  # the port's seeded text tower, named in its fingerprint
ALIGN_FILE = "align.pt"  # a run's align MLP: {"state_dict", "in_dim", "out_dim"}


def alignment_delay(u_ref: np.ndarray, u: np.ndarray) -> np.ndarray:
    """Per-row delay proxy: clip(1 - cos(align(T,T), align(T,V)), 0, 1)."""
    an = np.linalg.norm(u_ref, axis=-1) + 1e-9
    bn = np.linalg.norm(u, axis=-1) + 1e-9
    cos = np.sum(u_ref * u, axis=-1) / (an * bn)
    return np.clip(1.0 - cos, 0.0, 1.0).astype(np.float32)


def _l2n_rows(x: np.ndarray) -> np.ndarray:
    n = np.linalg.norm(x, axis=-1, keepdims=True)
    return (x / (n + 1e-9)).astype(np.float32)


def _fit_dim_rows(x: np.ndarray, dim: int) -> np.ndarray:
    if x.shape[1] == dim:
        return x
    if x.shape[1] > dim:
        return x[:, :dim]
    out = np.zeros((x.shape[0], dim), dtype=np.float32)
    out[:, : x.shape[1]] = x
    return out


def make_encoders(
    text_dim: int = 768,
    audio_dim: int = 128,
    visual_dim: int = 512,
    temporal_dim: int = 256,
    seed: int = 42,
    with_evidence: bool = True,
    device: str = "cuda",
    text_device: Optional[str] = None,
) -> Dict[str, Any]:
    """The encoder set of the cache contract, built once and reusable:
    "text", "audio", "flow", "ela", "tsync" and, `with_evidence`,
    "affective" and "semantic". The align MLP ("tsync") is the seeded draw
    on `device` (cuda by default; raises without a GPU). The ladders' device
    rungs (the text tower, the HF twins of BERT, the emotion classifier and
    CLIP's text tower) run on `text_device` (default `device`)."""
    dev = resolve_device(device)
    twins = text_device or str(dev)
    proxy = ProxyTextEncoder(visual_dim // 2)  # flow and ELA: one hash rung
    enc: Dict[str, Any] = {
        "text": TextFieldEncoder(text_dim, device=twins),
        "audio": ProxyTextEncoder(audio_dim),
        "flow": proxy,
        "ela": proxy,
        "tsync": TemporalSyncNet(text_dim, temporal_dim, seed=seed, device=str(dev)),
    }
    if with_evidence:
        enc["affective"] = AffectiveForensics.from_config(device=twins)
        enc["semantic"] = SemanticForgeryAnalyzer.from_config(device=twins)
    return enc


def build_feature_cache(
    raw: Any,
    ocr_phrase_pkl: Optional[str] = None,
    text_dim: int = 768,
    audio_dim: int = 128,
    visual_dim: int = 512,
    temporal_dim: int = 256,
    seed: int = 42,
    encoders: Optional[Dict[str, Any]] = None,
    ocr_clean_fallback: Optional[bool] = None,
    with_evidence: bool = True,
    with_tower_tokens: bool = True,
    with_align: bool = True,
    timings: Optional[Dict[str, float]] = None,
) -> Dict[str, Any]:
    """The cache of `raw` (anything with `__len__` and `get_item(i)` ->
    {id, title, ocr, comments, label}); the JAX function's keys for every
    combination of flags.

    `with_align=False` is the host-only half the serving featurizer runs:
    no align pass, and "temporal", "aux" and "evidence" are replaced by
    their host halves, "emo" (N,) and, `with_evidence`, "evidence_host"
    (N, 2) = [semantic gap, emotion intensity]; the scoring program
    computes the rest. `encoders` defaults to `make_encoders(...,
    with_evidence)` on the GPU. `timings`, when given, receives the
    seconds of the host work ("host_s") and of the align pass ("align_s").
    """
    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    n = len(raw)
    enc = encoders or make_encoders(text_dim, audio_dim, visual_dim, temporal_dim, seed,
                                    with_evidence)
    records = [raw.get_item(i) for i in range(n)]
    ids = np.array([r["id"] for r in records], dtype=object)
    labels = np.array([r["label"] for r in records], dtype=np.int64)

    T = enc["text"].encode_fields_batch(records)

    text_ids = text_mask = None
    if with_tower_tokens:
        combined = [
            " ".join([r["title"] or "", r["ocr"] or "", *(r["comments"] or [])[:10]]).strip()
            for r in records
        ]
        text_ids, text_mask = hash_tokenize_batch(combined, TOWER_IDS_LEN, TOWER_VOCAB)

    audio_proxies = [
        (r["title"] or "") + " " + (" ".join(r["comments"][:1]) if r["comments"] else "")
        for r in records
    ]
    A = enc["audio"].extract_text_batch(audio_proxies)

    vis_proxies = [r["ocr"] or r["title"] or "" for r in records]
    flow = enc["flow"].extract_text_batch(vis_proxies)
    # one hash rung serves both halves (make_encoders): embed once
    ela = flow if enc["ela"] is enc["flow"] else enc["ela"].ela_lbp_text_batch(vis_proxies)
    V = _l2n_rows(_fit_dim_rows(np.concatenate([flow, ela], axis=1), visual_dim))

    emo = np.array(
        [
            min(1.0, 0.1 * sum(term in ((r["title"] or "") + (r["ocr"] or ""))
                               for term in EMO_TERMS))
            for r in records
        ],
        dtype=np.float32,
    )

    ev_host = None
    if with_evidence:
        titles = [r["title"] or "" for r in records]
        ocrs = [r["ocr"] or "" for r in records]
        texts_full = [(r["title"] or "") + " " + (r["ocr"] or "") for r in records]
        ev_host = np.stack(
            [enc["semantic"].gap_magnitude(titles, ocrs),
             enc["affective"].analyze_batch(texts_full)["intensity"]],
            axis=1,
        ).astype(np.float32)

    ocr_sets = ocr_sets_for_records(records, ocr_phrase_pkl, clean_fallback=ocr_clean_fallback)
    split = make_split(labels, rng)
    host_s = time.perf_counter() - t0

    out: Dict[str, Any] = {
        "ids": ids,
        "labels": labels,
        "text": T.astype(np.float32),
        "audio": A.astype(np.float32),
        "visual": V.astype(np.float32),
        "ocr_sets": ocr_sets,
        "split": split,
    }
    t1 = time.perf_counter()
    if with_align:
        # align(T, V) and the reference align(T, T) as one 2N-row pass
        U, U_tt = enc["tsync"].align_batch_pair(T, V)
        delay = alignment_delay(U_tt, U)
        out["temporal"] = U.astype(np.float32)
        out["aux"] = np.stack([delay, emo], axis=1)
        if ev_host is not None:
            out["evidence"] = np.concatenate([ev_host, delay[:, None]], axis=1)
    else:
        out["emo"] = emo
        if ev_host is not None:
            out["evidence_host"] = ev_host
    if timings is not None:
        timings.update(host_s=host_s, align_s=time.perf_counter() - t1)
    if text_ids is not None:
        out["text_ids"] = text_ids
        out["text_mask"] = text_mask
    return out


def cache_fingerprint(data_root: str, seed: int, ocr_phrase_pkl: Optional[str]) -> str:
    """Config identity of a cache built here: the JAX fingerprint's fields
    (data root, seed, OCR pickle, and the hash salt when one is set) plus
    the port's align draw, the text rung when it is not the hash rung
    (`models/encoders.text_rung`: "text_rung": "tower-seeded" with
    "text_init": "torch", the port's seeded draw, "tower:<path>/<slot>", or
    "hf:<model>:device" / "hf:<model>:host"), and the evidence scorers' HF
    rungs when they load ("evidence_rungs": {"semantic": ..., "affective":
    ...}, `clip_rung`, `emotion_rung`), so a hash-rung fingerprint is the
    same as before the other rungs existed and no rung takes another's
    cache. The JAX fingerprint names no rung (ROADMAP.md, faults of the
    reference). The feature-code version is stored beside it."""
    cfg: Dict[str, Any] = {
        "data_root": str(Path(data_root).resolve()),
        "seed": int(seed),
        "ocr_phrase_pkl": str(Path(ocr_phrase_pkl).resolve()) if ocr_phrase_pkl else None,
        "align_init": ALIGN_INIT,
    }
    salt = get_hash_salt()
    if salt:
        cfg["hash_salt"] = salt
    rung = text_rung()
    if rung is not None:
        cfg["text_rung"] = rung
        if rung == "tower-seeded":
            cfg["text_init"] = TEXT_INIT
    evidence = {k: v for k, v in (("semantic", clip_rung()), ("affective", emotion_rung())) if v}
    if evidence:
        cfg["evidence_rungs"] = evidence
    return json.dumps(cfg, sort_keys=True)


def _parse_fingerprint(fp: str) -> Tuple[Optional[Dict[str, Any]], Optional[int]]:
    """(config dict without 'features', features version) of a stored
    fingerprint; (None, None) for a non-JSON one ('injected', or the empty
    one of files that predate fingerprints). Older fingerprints carry the
    version inside the JSON; absent means v1."""
    try:
        d = json.loads(fp)
    except ValueError:
        return None, None
    if not isinstance(d, dict):
        return None, None
    feat = d.pop("features", 1)
    return d, int(feat)


def save_cache(cache: Dict[str, Any], path: str, fingerprint: str = "") -> None:
    """Write `cache` in the npz format, atomically (tmp + rename)."""
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    tmp = p.with_name(f".{p.name}.tmp-{os.getpid()}.npz")
    n = len(cache["labels"])
    tr, va, te = cache["split"]
    np.savez_compressed(
        tmp,
        version=np.int64(CACHE_VERSION),
        features_version=np.int64(FEATURES_VERSION),
        fingerprint=np.str_(fingerprint),
        ids=np.array([str(x) for x in cache["ids"]]),
        labels=cache["labels"],
        text=cache["text"],
        audio=cache["audio"],
        visual=cache["visual"],
        temporal=cache["temporal"],
        aux=cache["aux"],
        evidence=cache.get("evidence", np.zeros((n, 3), np.float32)),
        text_ids=cache.get("text_ids", np.zeros((n, TOWER_IDS_LEN), np.int32)),
        text_mask=cache.get("text_mask", np.zeros((n, TOWER_IDS_LEN), np.float32)),
        ocr_sets=np.array(
            [json.dumps(sorted(s), ensure_ascii=False) for s in cache["ocr_sets"]]
        ),
        split_train=tr,
        split_val=va,
        split_test=te,
    )
    os.replace(tmp, p)  # readers see old-or-complete, never partial


def load_cache(
    path: str,
    expected_fingerprint: Optional[str] = None,
    stale_features: str = "rebuild",
) -> Optional[Dict[str, Any]]:
    """Read a cache written by the JAX package or by `save_cache`; None
    means absent or unusable (the caller rebuilds), as the JAX loader
    decides (`data/cache.py:448-538`):

      * an unknown cache version, or an unreadable file: None;
      * `expected_fingerprint` given and a stored one of another config
        (the align draw included): None; a file without a fingerprint is
        reused with a warning;
      * built by other feature code (its `features_version`, else the
        version in its fingerprint): None under `stale_features="rebuild"`
        (fresh training); under "reuse" (eval_only, resume, serving: a
        checkpoint was trained on exactly these features) it loads with a
        warning.

    A v2 cache (no token ids) loads with zero ids.
    """
    p = Path(path)
    if not p.exists():
        return None
    try:
        with np.load(p, allow_pickle=False) as z:
            version = int(z["version"])
            if version not in (2, CACHE_VERSION):
                return None
            if version == 2:
                print(f"note: cache at {p} is v2 (no token ids); "
                      "--train_text_tower needs a rebuilt cache")
            stored = str(z["fingerprint"]) if "fingerprint" in z else ""
            stored_cfg, stored_feat = _parse_fingerprint(stored)
            if "features_version" in z:
                stored_feat = int(z["features_version"])
            if expected_fingerprint is not None:
                exp_cfg, _ = _parse_fingerprint(expected_fingerprint)
                if stored and stored_cfg != exp_cfg:
                    print(f"⚠️  cache at {p} was built under a different config "
                          "(data_root/seed/ocr_phrase_pkl/align draw/text rung) — rebuilding")
                    return None
                if not stored:
                    print(f"⚠️  cache at {p} predates config fingerprints; "
                          "reusing — delete it to force a rebuild")
            if stored_feat is not None and stored_feat != FEATURES_VERSION:
                if stale_features != "reuse":
                    print(f"note: cache at {p} was built by older feature code "
                          f"(v{stored_feat}); rebuilding with current features")
                    return None
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
    except (OSError, ValueError, KeyError, zipfile.BadZipFile):
        return None


def save_align(out_dir: str, state_dict: Dict[str, Any], in_dim: int, out_dim: int) -> None:
    """Keep the align MLP a run's cache was built with in `<out_dir>/align.pt`."""
    p = Path(out_dir) / ALIGN_FILE
    p.parent.mkdir(parents=True, exist_ok=True)
    tmp = p.with_name(f".{p.name}.tmp-{os.getpid()}")
    torch.save({"state_dict": {k: v.detach().cpu() for k, v in state_dict.items()},
                "in_dim": int(in_dim), "out_dim": int(out_dim)}, tmp)
    os.replace(tmp, p)


def load_align(out_dir: str) -> Optional[Dict[str, Any]]:
    """`<out_dir>/align.pt` ({"state_dict", "in_dim", "out_dim"}) or None."""
    p = Path(out_dir) / ALIGN_FILE
    if not p.exists():
        return None
    return torch.load(p, map_location="cpu", weights_only=True)


def _model_dir_align(model_dir: str) -> Optional[Tuple[Dict[str, Any], int, int]]:
    """(state dict, in_dim, out_dim) of a model directory's align MLP; None
    for a directory without one (a bare out_dir holding only a cache)."""
    root = Path(model_dir)
    if not ((root / "meta.json").exists() and (root / "weights.pt").exists()):
        return None
    with open(root / "meta.json", "r", encoding="utf-8") as fh:
        dims = json.load(fh).get("align")
    weights = torch.load(root / "weights.pt", map_location="cpu", weights_only=True, mmap=True)
    if dims is None or "align" not in weights:
        return None
    return weights["align"], int(dims["in_dim"]), int(dims["out_dim"])


def bootstrap_cache(
    out_dir: str,
    model_dir: Optional[str] = None,
    cache: Optional[Dict[str, Any]] = None,
    cache_to_disk: bool = True,
    reuse_stale_features: bool = False,
    data_root: Optional[str] = None,
    ocr_phrase_pkl: Optional[str] = None,
    seed: int = 42,
    device: str = "cuda",
) -> Tuple[Dict[str, Any], str]:
    """The trainer's feature cache and where it came from: "injected" >
    "out_dir" (`<out_dir>/feature_cache.npz`) > "model_dir" (a model
    directory's cache) > "data_root" (built here, its align pass on
    `device`).

    * An injected cache is written to out_dir (when it has none) stamped
      "injected", never with this call's fingerprint.
    * out_dir's own cache is reused when usable (`load_cache`, with
      `stale_features="reuse"` under `reuse_stale_features`, i.e.
      eval_only / resume). Without a model_dir it must carry the
      fingerprint of (data_root, seed, ocr_phrase_pkl, salt, align draw);
      a run on a model_dir's cache compares none (its copy carries the
      exporter's fingerprint).
    * A model_dir's cache (`scripts/export_torch_model.py`, or the port's
      own exports) is copied byte for byte into out_dir, and its align
      weights, when it has them, into `<out_dir>/align.pt`.
    * Otherwise the cache is built from `data_root` (FileNotFoundError
      without its data_complete.json) and written with the port's
      fingerprint, its align MLP into `<out_dir>/align.pt`.
    `align.pt` is what `utils/transfer.export_trained` serves the run with.
    """
    own = Path(out_dir) / "feature_cache.npz"
    if cache is not None:
        if cache_to_disk and not own.exists():
            save_cache(cache, str(own), fingerprint="injected")
        return cache, "injected"
    fp = cache_fingerprint(data_root, seed, ocr_phrase_pkl) if data_root is not None else None
    if cache_to_disk:
        got = load_cache(str(own), expected_fingerprint=fp if model_dir is None else None,
                         stale_features="reuse" if reuse_stale_features else "rebuild")
        if got is not None:
            print(f"feature cache: reusing {own}")
            return got, "out_dir"
    if model_dir is not None:
        src = Path(model_dir) / "feature_cache.npz"
        got = load_cache(str(src))  # no checkpoint of out_dir was trained on it
        if got is not None:
            print(f"feature cache: taking {src}")
            if cache_to_disk:
                own.parent.mkdir(parents=True, exist_ok=True)
                tmp = own.with_name(f".{own.name}.tmp-{os.getpid()}.npz")
                shutil.copyfile(src, tmp)
                os.replace(tmp, own)
                align = _model_dir_align(model_dir)
                if align is not None:
                    save_align(out_dir, *align)
            return got, "model_dir"
    if data_root is None:
        raise FileNotFoundError(
            f"no usable feature_cache.npz in {out_dir}"
            + (f" or {model_dir}" if model_dir else "")
            + " and no data_root to build one from"
        )
    raw = FakeSVRawDataset(data_root)
    enc = make_encoders(seed=seed, device=device)
    seconds: Dict[str, float] = {}
    built = build_feature_cache(raw, ocr_phrase_pkl=ocr_phrase_pkl, seed=seed, encoders=enc,
                                timings=seconds)
    tsync = enc["tsync"]
    print(f"feature cache: built from {data_root} ({len(raw)} records): host featurize "
          f"{seconds['host_s']} s, align pass {seconds['align_s']} s on {tsync.device}, "
          f"text rung {text_rung() or 'hash'}")
    if cache_to_disk:
        save_cache(built, str(own), fingerprint=fp)
        save_align(out_dir, tsync.module.state_dict(), tsync.in_dim, tsync.out_dim)
    return built, "data_root"
