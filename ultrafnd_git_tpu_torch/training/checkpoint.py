"""Checkpoint store: `best` and `latest` slots under out_dir (torch files in
place of the JAX package's Orbax store, `training/checkpoint.py`).

A slot `<out_dir>/<name>/` holds `state.pt`, the `TrainState.state_dict()`
(parameters, AdamW moments and count, step, dropout generator state),
written with torch.save and read with `torch.load(weights_only=True)`, and
`meta.json` in the JAX layout (trainer, epoch, best_val_auc, no_improve,
cfg, np_random_state, plus the resolved module dims under "model"). Writes
are synchronous. Commit protocol as in the JAX store: the old meta.json is
removed first and the new one renamed into place after the state file, so
a meta.json means a complete slot. In a process group every rank calls
`save_checkpoint` (the gather of tensor-parallel shards in `state_dict()`
is collective) and rank 0 alone writes, as JAX's process 0.

`read_slot` is the one reader of a trained out_dir's slot for serving (the
Predictor's `out_dir=` and the text ladder's trained tower): a named slot,
or `best` then `latest` as the JAX `DeviceTextEncoder.from_checkpoint`
tries them. A slot of the JAX package (an Orbax `state/` directory, no
`state.pt`) is refused with the way across, `scripts/export_torch_model.py`.
"""
from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist


def is_primary() -> bool:
    """Whether this process writes the run's files: rank 0 of a process
    group, or a process outside one (JAX: `jax.process_index() == 0`)."""
    return not dist.is_initialized() or dist.get_rank() == 0


def save_checkpoint(directory: str, name: str, state, meta: Dict[str, Any]) -> None:
    """Write `state` (a TrainState) and `meta` into `directory/name`; on a
    rank other than 0, only take part in the state's gather."""
    payload = state.state_dict()
    if not is_primary():
        return
    root = Path(directory).resolve() / name
    root.mkdir(parents=True, exist_ok=True)
    meta_path = root / "meta.json"
    meta_path.unlink(missing_ok=True)
    tmp = root / f".state.pt.{os.getpid()}.tmp"
    torch.save(payload, tmp)
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


SLOTS = ("best", "latest")


def find_slot(directory: str, name: Optional[str] = None) -> str:
    """The slot `read_slot` reads: `name`, or the first of `best`, `latest`
    holding a meta.json. FileNotFoundError when there is none; ValueError for
    a slot written by the JAX package."""
    root = Path(directory)
    slots = [name] if name else list(SLOTS)
    for slot in slots:
        if (root / slot / "meta.json").exists():
            if not (root / slot / "state.pt").exists() and (root / slot / "state").is_dir():
                raise ValueError(
                    f"{root / slot} is a checkpoint of the JAX package (an Orbax state/ "
                    "directory): carry it across with python scripts/export_torch_model.py "
                    f"--out_dir {root} --checkpoint {slot} --model_dir M and serve M")
            return slot
    raise FileNotFoundError(f"no checkpoint slot ({'/'.join(slots)}) under {root}")


def read_slot(
    directory: str, name: Optional[str] = None
) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """(state payload, meta) of the slot `find_slot` picks."""
    return load_checkpoint(directory, find_slot(directory, name))
