"""Flat `key: value` YAML, read without PyYAML, and the module configs built from it.

Counterpart of `ultrafnd_git_tpu/utils/config.py`'s `ConfigManager.load_config`
for the files the trainers read (`configs/model_configs/fusion.yaml`,
`classifier.yaml`): a relative path that does not exist from the working
directory is resolved against the repository root, and a missing file gives
`{}`, so every default holds. The GPU machine has no PyYAML, and these files
are flat, so this reader takes only that: one `key: value` per line, `#`
comments, blank lines. Anything else (an indented line, a list item, a key
without a value, a flow collection) raises ValueError instead of being read
as something else.

Scalars follow YAML 1.1 as PyYAML's safe loader reads them: true / false
(also yes / no / on / off), null / ~, ints, floats with a dot, quoted
strings; anything else is a string.

`fusion_config` and `classifier_config` give the keyword arguments of the
port's modules with the keys and defaults of the JAX
`CrossModalTransformer.from_config` (`models/fusion.py:104`) and
`DeepTruthClassifier.from_config` (`models/classifier.py:80`).
"""
from __future__ import annotations

import re
from pathlib import Path
from typing import Any, Dict

REPO_ROOT = Path(__file__).resolve().parents[2]
FUSION_CONFIG = "configs/model_configs/fusion.yaml"
CLASSIFIER_CONFIG = "configs/model_configs/classifier.yaml"

_TRUE = {"true", "True", "TRUE", "yes", "Yes", "YES", "on", "On", "ON"}
_FALSE = {"false", "False", "FALSE", "no", "No", "NO", "off", "Off", "OFF"}
_INT = re.compile(r"[-+]?(0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"[-+]?([0-9][0-9_]*)?\.[0-9_]*([eE][-+][0-9]+)?$")
_KEY = re.compile(r"[A-Za-z_][\w.-]*$")


def _scalar(text: str, where: str) -> Any:
    if text[:1] in "\"'":
        if len(text) < 2 or text[-1] != text[0]:
            raise ValueError(f"{where}: unterminated quoted value {text!r}")
        return text[1:-1]
    if text[:1] in "[{&*!|>" or text == "-" or text.startswith("- "):
        raise ValueError(f"{where}: not a flat scalar value: {text!r}")
    if text in _TRUE:
        return True
    if text in _FALSE:
        return False
    if text in ("null", "Null", "NULL", "~"):
        return None
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _FLOAT.match(text) and any(c.isdigit() for c in text):
        return float(text.replace("_", ""))
    return text


def _strip_comment(line: str) -> str:
    """The line without a `#` comment (a `#` at its start or after a space,
    outside quotes)."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            quote = None if ch == quote else quote
        elif ch in "\"'":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def load_flat_yaml(path: str) -> Dict[str, Any]:
    """The `key: value` pairs of a flat YAML file; `{}` when the file does not
    exist (from the working directory or the repository root)."""
    p = Path(path)
    if not p.exists() and not p.is_absolute() and (REPO_ROOT / p).exists():
        p = REPO_ROOT / p
    if not p.is_file():
        return {}
    out: Dict[str, Any] = {}
    for n, raw in enumerate(p.read_text(encoding="utf-8").splitlines(), start=1):
        line = _strip_comment(raw).rstrip()
        if not line.strip() or line.strip() == "---":
            continue
        where = f"{p}:{n}"
        if line[0] in " \t":
            raise ValueError(f"{where}: nested YAML is not read here (flat key: value only)")
        key, sep, value = line.partition(":")
        key, value = key.strip(), value.strip()
        if not sep or not _KEY.match(key) or not value:
            raise ValueError(f"{where}: not a flat `key: value` line: {raw!r}")
        if key in out:
            raise ValueError(f"{where}: key {key!r} given twice")
        out[key] = _scalar(value, where)
    return out


def fusion_config(path: str = FUSION_CONFIG) -> Dict[str, Any]:
    """CrossModalTransformer settings: hidden, dropout and use_gnn (the
    fusion's GCN input is on only where the trainer's use_gnn is too)."""
    cfg = load_flat_yaml(path)
    return {"hidden": int(cfg.get("hidden_dim", 512)),
            "dropout": float(cfg.get("dropout", 0.1)),
            "use_gnn": bool(cfg.get("use_gnn", True))}


def classifier_config(path: str = CLASSIFIER_CONFIG) -> Dict[str, Any]:
    """DeepTruthClassifier keyword arguments (its in_dim is the fusion's
    hidden width, which the YAML's input_dim does not override)."""
    cfg = load_flat_yaml(path)
    return {"hidden": int(cfg.get("hidden_dim", 512)),
            "dropout": float(cfg.get("dropout", 0.1)),
            "num_classes": int(cfg.get("num_classes", 2)),
            "use_aux": bool(cfg.get("use_aux", True)),
            "aux_dim": int(cfg.get("aux_dim", 2)),
            "node_trees": int(cfg.get("node_trees", 6)),
            "node_depth": int(cfg.get("node_depth", 4)),
            "node_tau": float(cfg.get("node_tau", 10.0)),
            "node_dropout": float(cfg.get("node_dropout", 0.3)),
            "temperature_init": float(cfg.get("temperature", 1.0))}
