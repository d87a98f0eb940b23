"""Export a checkpoint slot of the port's trainer to a reference `best.pt`
(counterpart of scripts/export_reference_checkpoint.py; the inverse of
`import_reference`):

    python -m ultrafnd_git_tpu_torch.export_reference --out_dir outputs \
        [--slot best|latest] [--dest /path/best.pt] [--verify [--reference_tree DIR]]

The file is `torch.save({"fusion", "clf", "gnn" | None, "cfg"})` in the
layout the reference's v2 trainer writes and strict-loads
(`utils/transfer.best_pt_from_port_state_dicts`): the fusion with its
zero-filled `semantic.*` projections, every tree's `tau` the slot's
node_tau (its meta "model"), and `cfg` in the reference TrainConfig's
vocabulary plus provenance. The reference CLI's `--eval_only` then takes
the weights back.

* Needs only the slot, no dataset. A slot of the JAX package (an Orbax
  state/ directory) is refused with the way across, as is a slot of
  another trainer than v2.
* A `--train_text_tower` slot exports its fusion, classifier and GCN but
  not the tower, which the reference cannot load; a warning says so.
* `--verify` strict-loads the file into the reference's own modules (the
  reference source tree at `--reference_tree`) and holds their logits on
  random features to the port's fusion and classifier forward within 1e-4;
  without the tree it prints "skipped" and exits 0.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

EXPORT_TOOL = "ultrafnd_git_tpu_torch/export_reference.py"
VERIFY_ATOL = 1e-4


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="Export a slot of the port to a reference best.pt")
    ap.add_argument("--out_dir", type=str, required=True,
                    help="trained out_dir containing the slot")
    ap.add_argument("--slot", type=str, default="best", choices=("best", "latest"))
    ap.add_argument("--dest", type=str, default=None,
                    help="output path (default: <out_dir>/best.pt)")
    ap.add_argument("--verify", action="store_true",
                    help="strict-load into the live reference modules and "
                         "compare logits with the port's forward")
    ap.add_argument("--reference_tree", type=str, default=None,
                    help="the reference's source tree (holding src/) for --verify")
    return ap.parse_args(argv)


def export_slot(out_dir: str, slot: str, dest: str) -> dict:
    """Read `slot` of `out_dir` and write a reference best.pt at `dest`;
    returns the payload that was saved. FileNotFoundError without the slot,
    ValueError for a JAX slot or another trainer's."""
    import torch

    from ultrafnd_git_tpu_torch.training.checkpoint import read_slot
    from ultrafnd_git_tpu_torch.utils.transfer import best_pt_from_port_state_dicts

    state, meta = read_slot(out_dir, slot)
    if meta.get("trainer") not in (None, "v2"):
        raise ValueError(
            f"slot was written by trainer {meta.get('trainer')!r}; only v2 "
            "checkpoints map onto the reference's best.pt layout"
        )
    cfg = dict(meta.get("cfg") or {})
    params = state["params"]
    if "text_tower" in params:
        print(
            "warning: checkpoint carries a trained text tower — the "
            "reference has no analogue, so only fusion/clf/gnn are "
            "exported. Those heads were trained against TOWER text "
            "features; paired with the reference's own featurizer they "
            "will underperform their source accuracy."
        )
    payload = best_pt_from_port_state_dicts(
        {k: params[k] for k in ("fusion", "clf", "gnn") if k in params},
        node_tau=float(meta["model"]["classifier"]["node_tau"]))
    # cfg in the reference TrainConfig's vocabulary, key for key as the JAX export
    payload["cfg"] = {
        "data_root": cfg.get("data_root", ""),
        "ocr_phrase_pkl": cfg.get("ocr_phrase_pkl"),
        "out_dir": str(Path(dest).parent),
        "batch_size": int(cfg.get("batch_size", 16)),
        "epochs": int(cfg.get("epochs", 8)),
        "lr": float(cfg.get("lr", 2e-4)),
        "weight_decay": float(cfg.get("weight_decay", 1e-4)),
        "gnn_dim": int(cfg.get("gnn_dim", 128)),
        "gnn_overlap_thresh": float(cfg.get("gnn_overlap_thresh", 0.12)),
        "seed": int(cfg.get("seed", 42)),
        "use_mps": False,
        "use_gnn": bool(cfg.get("use_gnn", True)),
        "save_best": True,
        "grad_clip": float(cfg.get("grad_clip", 5.0)),
        "early_stop_patience": int(cfg.get("early_stop_patience", 3)),
        # provenance: the reference reads only the state dicts back
        "exported_from": str(Path(out_dir).resolve()),
        "exported_slot": slot,
        "export_tool": EXPORT_TOOL,
        "hash_salt": cfg.get("hash_salt"),
    }
    Path(dest).parent.mkdir(parents=True, exist_ok=True)
    torch.save(payload, dest)
    return payload


def verify_export(dest: str, model_meta: dict, reference_tree: str) -> float:
    """Strict-load `dest` into the reference's modules; the largest |logit
    difference| against the port's fusion and classifier on random
    features (fusion logits and classifier logits)."""
    import torch

    from ultrafnd_git_tpu_torch.serving import build_modules
    from ultrafnd_git_tpu_torch.utils.transfer import port_state_dicts_from_best_pt

    sys.path.insert(0, str(reference_tree))
    try:
        from src.models.fusion.cross_modal_transformer import (
            CrossModalTransformer as RefFusion,
        )
        from src.models.fusion.deep_truth_classifier import (
            DeepTruthClassifier as RefClassifier,
        )

        payload = torch.load(dest, map_location="cpu", weights_only=True)
        if not bool(payload["cfg"].get("use_gnn", True)):
            # the reference reads use_gnn from its fusion YAML, and its
            # no-GNN path fails: nothing to verify against
            print("--verify skipped: use_gnn=False exports have no "
                  "working reference-side loader")
            return 0.0
        ref_fusion = RefFusion()
        ref_fusion.load_state_dict(payload["fusion"])  # strict
        ref_clf = RefClassifier()
        ref_clf.load_state_dict(payload["clf"])  # strict
        ref_fusion.eval()
        ref_clf.eval()

        dims = {**model_meta, "align": {"in_dim": 1, "out_dim": 1}, "text_tower": None}
        mods = build_modules(dims)
        for part, sd in port_state_dicts_from_best_pt(payload).items():
            if part in ("fusion", "clf"):
                mods[part].load_state_dict(sd)
        f = model_meta["fusion"]
        rng = np.random.default_rng(0)
        b = 4
        feats = {
            "text_features": rng.standard_normal((b, f["text_dim"])),
            "audio_features": rng.standard_normal((b, f["audio_dim"])),
            "visual_features": rng.standard_normal((b, f["visual_dim"])),
            "temporal_features": rng.standard_normal((b, f["temporal_dim"])),
            "gnn_feat": rng.standard_normal((b, f["gnn_dim"])),
        }
        feats = {k: torch.from_numpy(v.astype(np.float32)) for k, v in feats.items()}
        aux = torch.from_numpy(rng.uniform(size=(b, 2)).astype(np.float32))
        with torch.no_grad():
            fused = ref_fusion(feats)
            ref_clf_logits = ref_clf(fused["fused"], aux)["logits"]
            ours = mods["fusion"].eval()(feats)
            ours_clf_logits = mods["clf"].eval()(ours["fused"], aux)["logits"]
        d_fusion = float((ours["logits"] - fused["logits"]).abs().max())
        d_clf = float((ours_clf_logits - ref_clf_logits).abs().max())
        return max(d_fusion, d_clf)
    finally:
        sys.path.remove(str(reference_tree))


def main(argv=None) -> int:
    args = parse_args(argv)
    dest = args.dest or str(Path(args.out_dir) / "best.pt")
    try:
        payload = export_slot(args.out_dir, args.slot, dest)
    except (FileNotFoundError, ValueError) as exc:
        print(f"error: {exc}")
        return 2
    gnn_note = "+gnn" if payload["gnn"] is not None else ""
    print(f"exported {args.out_dir}/{args.slot} -> {dest} "
          f"(fusion {len(payload['fusion'])} tensors, clf {len(payload['clf'])}{gnn_note})")
    if Path(dest).name == "best.pt":
        print("consume it with the REFERENCE CLI: python run_train_eval.py "
              f"--data_root <data> --out_dir {Path(dest).parent} --eval_only")
    else:
        # the reference's test() loads only <out_dir>/best.pt, and without
        # it evaluates random initial weights without a word
        print(f"note: the reference CLI only loads a file named best.pt — "
              f"rename {Path(dest).name} to best.pt inside the reference "
              "--out_dir before running --eval_only there")
    if args.verify:
        tree = args.reference_tree
        if not tree or not (Path(tree) / "src").exists():
            print("--verify skipped: reference tree not mounted")
            return 0
        from ultrafnd_git_tpu_torch.training.checkpoint import read_slot

        model_meta = read_slot(args.out_dir, args.slot)[1]["model"]
        delta = verify_export(dest, model_meta, tree)
        print(f"verify: max |logit delta| vs reference modules = {delta:.2e}")
        if delta > VERIFY_ATOL:
            print(f"error: exceeds fp32 tolerance {VERIFY_ATOL:g}")
            return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
