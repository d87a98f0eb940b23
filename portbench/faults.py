"""Faults planted under the timed path, to read what they do to the
numbers compared (`calibrate.py --fault`, the fault tests). Each is a
context manager that breaks one method of the port while it is open."""
from __future__ import annotations

from contextlib import contextmanager

import numpy as np


@contextmanager
def _patched(owner, name, make):
    original = getattr(owner, name)
    setattr(owner, name, make(original))
    try:
        yield
    finally:
        setattr(owner, name, original)


def unchanged():
    """The optimizer step returns the state as it was."""
    from ultrafnd_git_tpu_torch.kernels.adamw import FusedAdamW

    return _patched(FusedAdamW, "apply", lambda f: lambda self, params, state, grads: state)


def one_leaf_kept():
    """The optimizer step leaves one leaf's parameters as they were (its
    moments move): a fault of one leaf's update, which no median sees."""
    import torch

    from ultrafnd_git_tpu_torch.kernels.adamw import FusedAdamW

    def make(apply):
        def kept(self, params, state, grads):
            leaves = [p for part, mod in params.items() if part not in self.frozen
                      for p in mod.parameters()]
            leaf = leaves[len(leaves) // 2]
            old = leaf.detach().clone()
            out = apply(self, params, state, grads)
            with torch.no_grad():
                leaf.copy_(old)
            return out
        return kept

    return _patched(FusedAdamW, "apply", make)


def half_batch():
    """A train step over the first half of its rows, the mean taken over them."""
    from ultrafnd_git_tpu_torch.training.trainer import ForensicTrainer

    def make(step):
        def half(self, idx, mask):
            mask = np.array(mask)
            mask[len(mask) // 2:] = 0.0
            return step(self, idx, mask)
        return half

    return _patched(ForensicTrainer, "train_step", make)


def altered_token():
    """One token of a request's first string altered where it is read."""
    from ultrafnd_git_tpu_torch.models.bert import DeviceBertEncoder

    def make(encode):
        def altered(self, ids, mask):
            ids = np.array(ids)
            ids[0, 1] = ids[0, 1] + 1
            return encode(self, ids, mask)
        return altered

    return _patched(DeviceBertEncoder, "encode_ids", make)


def dropped_rows():
    """Half of a request's rows left out (zeros)."""
    from ultrafnd_git_tpu_torch.models.bert import DeviceBertEncoder

    def make(encode):
        def dropped(self, ids, mask):
            rows = encode(self, ids, mask)
            rows[len(rows) // 2:] = 0.0
            return rows
        return dropped

    return _patched(DeviceBertEncoder, "encode_ids", make)


def attention_grad():
    """The attention backward's query gradient off by 10%: a fault that
    reaches only the tower's leaves."""
    from ultrafnd_git_tpu_torch.kernels import flash_attention as fa

    def make(bwd):
        def off(*args, **kwargs):
            dq, dk, dv, dbias = bwd(*args, **kwargs)
            return 0.9 * dq, dk, dv, dbias
        return off

    return _patched(fa, "flash_attention_bwd", make)


FAULTS = {"unchanged": unchanged, "half_batch": half_batch, "altered_token": altered_token,
          "dropped_rows": dropped_rows, "attention_grad": attention_grad,
          "one_leaf_kept": one_leaf_kept}
