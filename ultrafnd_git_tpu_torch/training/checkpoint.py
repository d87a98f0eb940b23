"""Checkpoint store: `best` and `latest` slots under out_dir (torch files in
place of the JAX package's Orbax store, `training/checkpoint.py`).

A slot `<out_dir>/<name>/` holds `state.pt`, the `TrainState.state_dict()`
(parameters, AdamW moments and count, step, dropout generator state),
written with torch.save and read with `torch.load(weights_only=True)`, and
`meta.json` in the JAX layout (trainer, epoch, best_val_auc, no_improve,
cfg, np_random_state, plus the resolved module dims under "model"). Writes
are synchronous. Commit protocol as in the JAX store: the old meta.json is
removed first and the new one renamed into place after the state file, so
a meta.json means a complete slot.
"""
from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import torch


def save_checkpoint(directory: str, name: str, state, meta: Dict[str, Any]) -> None:
    """Write `state` (a TrainState) and `meta` into `directory/name`."""
    root = Path(directory).resolve() / name
    root.mkdir(parents=True, exist_ok=True)
    meta_path = root / "meta.json"
    meta_path.unlink(missing_ok=True)
    tmp = root / f".state.pt.{os.getpid()}.tmp"
    torch.save(state.state_dict(), tmp)
    os.replace(tmp, root / "state.pt")
    tmp_meta = root / "meta.json.tmp"
    tmp_meta.write_text(json.dumps(meta, ensure_ascii=False, indent=2), encoding="utf-8")
    os.replace(tmp_meta, meta_path)


def load_checkpoint(
    directory: str, name: str, map_location: Any = "cpu"
) -> Optional[Tuple[Dict[str, Any], Dict[str, Any]]]:
    """(state payload, meta) of a complete slot, or None when absent."""
    root = Path(directory).resolve() / name
    meta_path = root / "meta.json"
    if not meta_path.exists():
        return None
    # mmap: a reader that takes only the parameters reads only their pages
    payload = torch.load(root / "state.pt", map_location=map_location, weights_only=True,
                         mmap=True)
    with open(meta_path, "r", encoding="utf-8") as fh:
        return payload, json.load(fh)


def checkpoint_exists(directory: str, name: str) -> bool:
    return (Path(directory).resolve() / name / "meta.json").exists()
