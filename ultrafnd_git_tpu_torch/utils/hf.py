"""Memoised, offline HuggingFace loading for the encoder ladders' HF rungs
(the port's copy of `ultrafnd_git_tpu/utils/hf.py`).

Each ladder loads its model and tokenizer through `load_once`, with
`local_files_only=True` in its loader, so that:

  * a load that cannot happen (no `transformers`, or no local weights) is
    tried once per process and model, and remembered as None: the ladder
    then takes its lower rung, as the JAX ladder does without weights;
  * `ULTRAFND_DISABLE_HF=1` turns every HF rung off (the tests' default).

Only those two absences give None: `ImportError`, and `OSError` or
`huggingface_hub`'s `HFValidationError`, which `transformers` raises for a
model name that names no local files. Anything else a loader raises
propagates. The JAX module's `try_build_device_rung` (warn and fall
back to the host forward when a device twin fails) has no copy here: a twin
that fails to build or to launch raises.

`import_transformers()` is how the loaders import the library, with three
variables set unless the caller set them: `HF_HUB_OFFLINE=1` (the loaders
read local files only, and `from_pretrained` asks the hub for an adapter
config even under `local_files_only=True`), and `USE_TF=0`, `USE_FLAX=0`,
so that on a machine with TensorFlow installed `transformers` does not
import it (and, through TensorFlow, jax): the port's process holds no jax
module.
"""
from __future__ import annotations

import os
from typing import Any, Callable, Dict, Optional

DISABLE_HF = "ULTRAFND_DISABLE_HF"

_MEMO: Dict[str, Optional[Any]] = {}


def hf_disabled() -> bool:
    return os.environ.get(DISABLE_HF, "0") == "1"


def load_once(key: str, loader: Callable[[], Any]) -> Optional[Any]:
    """Run `loader` once per key; remember its result, or None when it
    found no `transformers` or no local files."""
    if hf_disabled():
        return None
    if key not in _MEMO:
        try:
            _MEMO[key] = loader()
        except Exception as exc:  # noqa: BLE001 - re-raised unless an absence
            if not isinstance(exc, _absences()):
                raise
            _MEMO[key] = None
    return _MEMO[key]


def _absences() -> tuple:
    """The exceptions that mean "no library" or "no local files"."""
    try:
        from huggingface_hub.errors import HFValidationError
    except ImportError:
        return (ImportError, OSError)
    return (ImportError, OSError, HFValidationError)


def import_transformers():
    """`transformers`, imported offline with its TensorFlow and Flax
    backends off (unless the environment already chose)."""
    os.environ.setdefault("HF_HUB_OFFLINE", "1")
    os.environ.setdefault("USE_TF", "0")
    os.environ.setdefault("USE_FLAX", "0")
    import transformers

    return transformers


def reset_memo() -> None:  # test hook
    _MEMO.clear()
