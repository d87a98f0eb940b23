"""Validation-selected hash-salt search (`--auto_salt`).

The port's copy of `ultrafnd_git_tpu/training/salt_search.py`: train one
full run per candidate salt (the unsalted draw always among them), pick the
winner by the run's best validation `select_metric` (what
`ForensicTrainer.fit` returns; the test split is never read), and adopt the
winner's artifacts into the requested out_dir, so `--eval_only`,
`export_trained` and the Predictor serve the tuned draw. The offline hash
featurization draw carries much of the accuracy variance against the
reference (BASELINE.md, "Tuning the draw"); the salt makes it tunable like
a seed.

Candidates train one after another in this process: `ForensicTrainer` sets
the process-wide salt (`ops/hashing.set_hash_salt`) in its constructor, so
runs cannot interleave. Candidate runs live under
`out_dir/salt_search/<tag>/` and are kept. `salt_search.json` has the JAX
layout. Besides the JAX artifacts, `_adopt` carries the port's own
`align.pt` (the align MLP the run's cache was built with), without which
`export_trained` on the adopted out_dir would have no align weights.
"""
from __future__ import annotations

import dataclasses
import json
import shutil
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

from ultrafnd_git_tpu_torch.data.cache import ALIGN_FILE
from ultrafnd_git_tpu_torch.ops.hashing import set_hash_salt


def _tag(salt: str) -> str:
    """Directory tag of a candidate salt ('' -> 'unsalted'); a salt with a
    character rewritten gets a short SHA-1 of the raw salt, so distinct
    candidates never share a directory."""
    if salt == "":
        return "unsalted"
    safe = "".join(c if (c.isalnum() or c in "-_") else "_" for c in salt)
    if safe != salt:
        import hashlib  # not fnv1a_64: that hashes under the live salt

        safe = f"{safe}_{hashlib.sha1(salt.encode()).hexdigest()[:6]}"
    return f"salt_{safe}"


def search_hash_salt(
    cfg,
    salts: Sequence[str],
    trainer_cls=None,
    device: str = "cuda",
) -> Tuple[str, Dict[str, float]]:
    """Train one run per candidate salt (on `device`) and adopt the winner
    into cfg.out_dir; returns (winner, {salt: best validation metric}).

    Afterwards cfg.out_dir holds the winner's `best` / `latest` slots,
    feature cache, metrics log and align weights, and `salt_search.json`:
    a directory like one trained directly with `--hash_salt <winner>`. The
    process-wide salt is left on the winner's.
    """
    if trainer_cls is None:
        from ultrafnd_git_tpu_torch.training.trainer import ForensicTrainer

        trainer_cls = ForensicTrainer

    candidates: List[str] = [""]
    for s in salts:
        if s not in candidates:
            candidates.append(s)
    if len(candidates) < 2:
        raise ValueError(
            "--auto_salt needs at least one non-empty candidate salt "
            "(the unsalted draw is always included as the baseline)"
        )

    out_root = Path(cfg.out_dir).resolve()
    search_root = out_root / "salt_search"
    scores: Dict[str, float] = {}
    for salt in candidates:
        run_dir = search_root / _tag(salt)
        sub = dataclasses.replace(cfg, hash_salt=salt, out_dir=str(run_dir), eval_only=False)
        print(f"\n>>> [auto_salt] training candidate {_tag(salt)!r}")
        trainer = trainer_cls(sub, device=device)
        scores[salt] = float(trainer.fit())
        del trainer

    sel = {"acc": "accuracy"}.get(cfg.select_metric, cfg.select_metric)
    winner = max(candidates, key=lambda s: scores[s])
    print(f"\n==== auto_salt: best val {sel} per candidate ====")
    for salt in candidates:
        mark = " <- selected" if salt == winner else ""
        print(f"  {_tag(salt):>16}: {scores[salt]:.4f}{mark}")

    _adopt(search_root / _tag(winner), out_root)
    # each candidate set its own salt; featurization after the search must
    # use the winner's, under which the adopted checkpoints were trained
    set_hash_salt(winner)
    record = {
        "winner": winner,
        "select_metric": sel,
        "val_scores": {s: scores[s] for s in candidates},  # keyed by the raw salt
        "run_dirs": {s: _tag(s) for s in candidates},
        "candidates": candidates,
    }
    (out_root / "salt_search.json").write_text(json.dumps(record, indent=2))
    return winner, scores


def _adopt(run_dir: Path, out_root: Path) -> None:
    """Copy a candidate run's slots, feature cache, metrics log and align
    weights up into out_dir (a slot is copied whole; its meta.json is
    written last by the checkpoint store, so a present slot is complete)."""
    for name in ("best", "latest"):
        src = run_dir / name
        if not src.exists():
            continue
        dst = out_root / name
        if dst.exists():
            shutil.rmtree(dst)
        shutil.copytree(src, dst)
    for fname in ("feature_cache.npz", "metrics.jsonl", ALIGN_FILE):
        src = run_dir / fname
        if src.exists():
            shutil.copy2(src, out_root / fname)


def parse_salt_list(spec: Optional[str]) -> List[str]:
    """'a,b,c' -> ['a', 'b', 'c'] (empty segments dropped; None -> [])."""
    if not spec:
        return []
    return [s for s in (part.strip() for part in spec.split(",")) if s]
