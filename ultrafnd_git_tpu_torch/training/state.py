"""Train state and optimizer (counterpart of `training/state.py`).

`TrainState` holds what a checkpoint must carry for an exact resume: the
optimizer step, the parameters (a dict of `nn.Module`s, {"fusion", "clf",
["gnn"], ["text_tower"]}), the optimizer state {count, mu, nu} and the
dropout generator. `make_optimizer` builds the epoch-staircase AdamW of the
JAX trainer as `FusedAdamW`: one K1 launch per step on CUDA, the plain
update (optax op order, the same bits) per leaf on the CPU.

On a tensor-parallel mesh (`tp`, the model axis's `Shard`) the state holds
this rank's shards of the split parameters and of their AdamW moments
(`parallel/mesh.split_dim`); `state_dict` gathers them (every rank of the
axis must call it), so a checkpoint has the one-device layout, and
`load_state_dict` cuts a full payload to this rank's shards.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

from ultrafnd_git_tpu_torch.kernels.adamw import FusedAdamW
from ultrafnd_git_tpu_torch.parallel.collectives import Shard
from ultrafnd_git_tpu_torch.parallel.mesh import gather_state_dict, shard_state_dict


@dataclass
class TrainState:
    step: int
    params: Dict[str, nn.Module]
    opt_state: Dict[str, Any]  # {"count": int, "mu": {...}, "nu": {...}}
    gen: torch.Generator  # dropout masks (and the pretrain head draw)
    tp: Optional[Shard] = None  # the model axis of a tensor-parallel mesh

    def state_dict(self) -> Dict[str, Any]:
        """Tensors and ints only: loadable with torch.load(weights_only=True).
        Under `tp` the full tensors, gathered from every rank's shards."""
        opt = self.opt_state

        def full(trees):
            return {part: gather_state_dict(part, sd, self.tp) for part, sd in trees.items()}

        return {
            "step": torch.tensor(self.step, dtype=torch.int64),
            "params": full({k: m.state_dict() for k, m in self.params.items()}),
            "opt_state": {
                "count": torch.tensor(opt["count"], dtype=torch.int64),
                "mu": full(opt["mu"]),
                "nu": full(opt["nu"]),
            },
            "rng": self.gen.get_state(),
        }

    def local_payload(self, payload: Dict[str, Any]) -> Dict[str, Any]:
        """A full state payload with its split tensors cut to this rank's
        shards (the payload itself without `tp`)."""
        if self.tp is None:
            return payload

        def cut(trees):
            return {part: shard_state_dict(part, sd, self.tp) for part, sd in trees.items()}

        opt = payload["opt_state"]
        return {**payload, "params": cut(payload["params"]),
                "opt_state": {**opt, "mu": cut(opt["mu"]), "nu": cut(opt["nu"])}}

    def check_compatible(self, payload: Dict[str, Any]) -> None:
        """Raise ValueError unless `payload` has this state's structure."""
        for part, mod in self.params.items():
            saved = payload["params"].get(part)
            if saved is None:
                raise ValueError(f"checkpoint has no {part!r} parameters")
            ours = mod.state_dict()
            if set(saved) != set(ours) or any(
                saved[k].shape != ours[k].shape for k in ours
            ):
                raise ValueError(f"checkpoint {part!r} parameters differ in shape")
        if set(payload["params"]) != set(self.params):
            raise ValueError(
                f"checkpoint parts {sorted(payload['params'])} != "
                f"{sorted(self.params)}"
            )
        for key in ("mu", "nu"):  # the AdamW moments of the trained parts
            for part, leaves in self.opt_state[key].items():
                saved = payload["opt_state"][key].get(part, {})
                if set(saved) != set(leaves) or any(
                    saved[k].shape != t.shape for k, t in leaves.items()
                ):
                    raise ValueError(f"checkpoint {part!r} optimizer state differs in shape")

    @torch.no_grad()
    def load_state_dict(self, payload: Dict[str, Any]) -> None:
        """Load a full payload (`state_dict`'s), cut to this rank's shards."""
        payload = self.local_payload(payload)
        self.check_compatible(payload)
        for part, mod in self.params.items():
            mod.load_state_dict(payload["params"][part])
        opt = payload["opt_state"]
        for key in ("mu", "nu"):
            for part, leaves in self.opt_state[key].items():
                for name, t in leaves.items():
                    t.copy_(opt[key][part][name])
        self.opt_state["count"] = int(opt["count"])
        self.step = int(payload["step"])
        try:
            self.gen.set_state(payload["rng"].cpu())
        except RuntimeError:  # saved by a generator of another device type
            print("note: the checkpoint's dropout generator is from another "
                  "device type; the dropout stream restarts from the seed")


def staircase_schedule(
    lr: float, transition_steps: int, decay_rate: float
) -> Callable[[int], float]:
    """optax.exponential_decay(lr, transition_steps, decay_rate,
    staircase=True) in the same f32 arithmetic: lr * rate ** floor(count /
    transition_steps), and lr itself at count 0."""
    f32 = np.float32

    def schedule(count: int) -> float:
        if count <= 0:
            return float(f32(lr))
        p = np.floor(f32(count) / f32(transition_steps))
        return float(f32(lr) * np.power(f32(decay_rate), p, dtype=np.float32))

    return schedule


def make_optimizer(
    lr: float,
    weight_decay: float,
    grad_clip: float,
    steps_per_epoch: int,
    lr_decay_every_epochs: int = 3,
    lr_decay_rate: float = 0.7,
    frozen_subtrees: tuple = (),
) -> FusedAdamW:
    """AdamW + global-norm clipping + epoch-staircase LR decay.

    The staircase decays every `lr_decay_every_epochs * steps_per_epoch`
    optimizer steps. `frozen_subtrees` names parameter parts left out of
    the norm and untouched. The JAX trainer's `fused` choice has no
    counterpart: its two routes differ only in speed here, since K1 is
    bit-identical to the plain update, so every route runs K1 on CUDA.
    """
    schedule = staircase_schedule(
        lr, max(1, lr_decay_every_epochs * steps_per_epoch), lr_decay_rate
    )
    return FusedAdamW(
        schedule,
        weight_decay=weight_decay,
        grad_clip=grad_clip,
        frozen_subtrees=tuple(frozen_subtrees),
    )
