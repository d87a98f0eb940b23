#!/usr/bin/env python3
"""The bf16 envelope of one training step's gradient, on the CPU.

    JAX_PLATFORMS=cpu python scripts/bf16_grad_envelope.py [--rows 8 32]

Builds the JAX trainer with `bf16_compute=True` on the test fixture
(`tests/fixtures/fakesv_tiny`, tower depth 1, 4 heads of 192, batch 8),
clones its tower onto the Pallas bf16 attention in interpret mode, and
crosses its initial params to the port's trainer (`bf16_compute=True`,
CPU). For each row count (the first training rows, the last 3 masked) it
prints, for the three pairs port bf16 / JAX bf16, JAX bf16 / JAX f32 and
port bf16 / JAX f32, the leaves with the largest error relative to the
reference leaf's largest value and their relative L2 error. The JAX f32
gradient is the JAX trainer with `bf16_compute=False` on the same params.
Dropout is off. Needs jax, flax and the port; imports both packages.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import tempfile
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault("ULTRAFND_DISABLE_HF", "1")
REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from ultrafnd_git_tpu.training.trainer import ForensicTrainer, TrainConfig  # noqa: E402
from ultrafnd_git_tpu_torch.training import trainer as port  # noqa: E402
from ultrafnd_git_tpu_torch.utils.transfer import port_state_dicts  # noqa: E402

TOWER = dict(train_text_tower=True, text_tower_depth=1, text_tower_heads=4)


def jax_grads(jt, params, idx, mask):
    def loss_fn(p):
        ce, _, _ = jt._forward(p, jnp.asarray(idx), jt.corpus, deterministic=True)
        m = jnp.asarray(mask)
        return (ce * m).sum() / jnp.maximum(m.sum(), 1.0)

    _, g = jax.jit(jax.value_and_grad(loss_fn))(params)
    return port_state_dicts(jax.device_get(g), None, node_tau=10.0)


def gaps(a, b, keys, top=4):
    rows = []
    for part, names in keys.items():
        for name in names:
            r = np.asarray(b[part][name], np.float32)
            d = np.asarray(a[part][name], np.float32) - r
            rows.append((np.abs(d).max() / max(np.abs(r).max(), 1e-30),
                         np.linalg.norm(d) / max(np.linalg.norm(r), 1e-30), f"{part}.{name}"))
    by_max = sorted(rows, reverse=True)[:top]
    by_l2 = sorted(rows, key=lambda x: -x[1])[:top]
    fmt = lambda rs: ", ".join(f"{n} {m:.3g} (L2 {l2:.3g})" for m, l2, n in rs)  # noqa: E731
    return f"by max: {fmt(by_max)}\n    by L2: {fmt(by_l2)}"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, nargs="+", default=[8, 32])
    args = ap.parse_args(argv)
    root = Path(tempfile.mkdtemp(prefix="bf16_envelope_"))
    cfg = TrainConfig(data_root=str(REPO / "tests" / "fixtures" / "fakesv_tiny"),
                      out_dir=str(root / "jt"), batch_size=8, epochs=1, seed=0,
                      log_metrics_jsonl=False, bf16_compute=True, **TOWER)
    jt = ForensicTrainer(cfg)
    jt.text_tower = jt.text_tower.clone(attention_backend="interpret")
    jt32 = ForensicTrainer(dataclasses.replace(cfg, bf16_compute=False, out_dir=str(root / "f32")))
    params = jt.state.params
    pt = port.ForensicTrainer(port.TrainConfig(out_dir=str(root / "pt"), model_dir=str(root / "jt"),
                                               batch_size=8, epochs=1, seed=0,
                                               bf16_compute=True, **TOWER), device="cpu")
    for part, sd in port_state_dicts(jax.device_get(params), None, node_tau=10.0).items():
        pt.state.params[part].load_state_dict({k: torch.tensor(np.asarray(v)) for k, v in sd.items()})
    for n in args.rows:
        valid = n - 3
        idx = np.asarray(jt.tr_idx[:n], np.int32).copy()
        idx[valid:] = idx[valid - 1]
        mask = (np.arange(n) < valid).astype(np.float32)
        ref16, ref32 = jax_grads(jt, params, idx, mask), jax_grads(jt32, params, idx, mask)
        _, g, _ = pt.grads_of(torch.from_numpy(idx).long(), torch.from_numpy(mask))
        ours = {p: {k: v.numpy() for k, v in d.items()} for p, d in g.items()}
        print(f"rows={n} ({valid} valid)")
        keys = {p: list(d) for p, d in ours.items()}  # the parameters (not the buffers)
        print(f"  port bf16 vs JAX bf16 {gaps(ours, ref16, keys)}")
        print(f"  JAX bf16 vs JAX f32   {gaps(ref16, ref32, keys)}")
        print(f"  port bf16 vs JAX f32  {gaps(ours, ref32, keys)}", flush=True)


if __name__ == "__main__":
    main()
