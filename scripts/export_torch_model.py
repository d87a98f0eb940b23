#!/usr/bin/env python3
"""Export a trained JAX out_dir as a model directory for the PyTorch port.

Usage:
  python scripts/export_torch_model.py --out_dir outputs --model_dir torch_model

Restores the checkpoint exactly as the JAX serving Predictor does, carries
its parameters across with `ultrafnd_git_tpu_torch.utils.transfer`, and
writes into --model_dir:
  * weights.pt  — {fusion, clf, gnn, text_tower, align} state dicts; the
    temporal align MLP's params come from a jax.random.PRNGKey(seed) init
    that torch cannot draw again, so they are exported too;
  * meta.json   — the checkpoint cfg plus the resolved module dims (the
    port reads no YAML);
  * feature_cache.npz — a copy of the corpus cache.
A switch-MoE tower (`--moe_experts`) exports its router and stacked expert
arrays, and meta.json records its expert count and capacity factor.
An evidence checkpoint (`--use_evidence`) exports as any other: its cfg
carries the flag, and the port's Predictor computes the scorers' host
columns itself (lexicon and hash rungs, no weights). The semantic
analyzer's projector is not on the v2 path (the cache reads only its
`gap_magnitude`), so nothing of it is exported.
Serve the result with `python -m ultrafnd_git_tpu_torch.predict`, or
train from it with `python -m ultrafnd_git_tpu_torch.train --model_dir`:
the port's trainer reads its feature cache from the directory, and its
`--export_model_dir` takes the align weights from it.
"""
import argparse
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


def export(out_dir: str, model_dir: str, checkpoint: str = "best") -> Path:
    import jax

    from ultrafnd_git_tpu.serving import Predictor
    from ultrafnd_git_tpu_torch.utils.transfer import (
        port_state_dicts,
        write_model_dir,
    )

    pred = Predictor(out_dir, checkpoint_name=checkpoint)
    with open(Path(out_dir) / checkpoint / "meta.json", encoding="utf-8") as fh:
        cfg = json.load(fh).get("cfg", {})
    params = jax.device_get(pred.params)
    align = jax.device_get(pred._align_params)
    fusion, clf = pred.fusion, pred.clf
    cache = pred.cache
    meta = {
        "cfg": cfg,
        "fusion": {
            "hidden": int(fusion.hidden),
            "use_gnn": bool(fusion.use_gnn),
            "gnn_dim": int(pred.gnn.out_dim),  # what gnn_proj was built on
            "text_dim": int(cache["text"].shape[1]),
            "audio_dim": int(cache["audio"].shape[1]),
            "visual_dim": int(cache["visual"].shape[1]),
            "temporal_dim": int(cache["temporal"].shape[1]),
        },
        "classifier": {
            "hidden": int(clf.hidden),
            "num_classes": int(clf.num_classes),
            "use_aux": bool(clf.use_aux),
            "aux_dim": int(clf.aux_dim),
            "node_trees": int(clf.node_trees),
            "node_depth": int(clf.node_depth),
            "node_tau": float(clf.node_tau),
            "temperature_init": float(clf.temperature_init),
        },
        "gnn": {
            "in_dim": int(pred.XG.shape[1]),
            "hid": int(pred.gnn.hid),
            "out_dim": int(pred.gnn.out_dim),
        },
        "align": {
            "in_dim": int(pred._align_module.in_dim),
            "out_dim": int(pred._align_module.out_dim),
        },
        "text_tower": None,
    }
    if pred.text_tower is not None:
        t = pred.text_tower
        meta["text_tower"] = {
            "width": int(t.width),
            "depth": int(t.depth),
            "heads": int(t.heads),
            "vocab_size": int(t.vocab_size),
            "max_len": int(t.max_len),
            "gelu": str(t.gelu),
            "moe_experts": int(t.moe_experts),
            "moe_capacity_factor": float(t.moe_capacity_factor),
        }
    if not pred.use_gnn:
        params = {k: v for k, v in params.items() if k != "gnn"}
    sds = port_state_dicts(params, align, node_tau=float(clf.node_tau))
    return write_model_dir(
        model_dir, sds, meta, cache_npz=str(Path(out_dir) / "feature_cache.npz")
    )


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out_dir", required=True, help="trained JAX out_dir")
    ap.add_argument("--model_dir", required=True, help="where to write the export")
    ap.add_argument("--checkpoint", default="best", choices=("best", "latest"))
    ap.add_argument("--cpu", action="store_true", help="restore on the CPU")
    args = ap.parse_args()
    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")
    root = export(args.out_dir, args.model_dir, args.checkpoint)
    print(f"wrote {root}")


if __name__ == "__main__":
    main()
