"""Import a reference `best.pt` into a checkpoint slot of the port's trainer
(counterpart of scripts/import_reference_checkpoint.py):

    python -m ultrafnd_git_tpu_torch.import_reference /path/to/best.pt \
        --data_root data/fakesv --out_dir outputs_imported \
        [--ocr_phrase_pkl P] [--model_dir D] [--eval] [--device cuda|cpu | --cpu]

A checkpoint written by the reference's v2 trainer
(`torch.save({"fusion", "clf", "gnn", "cfg"})`) becomes the `best` and
`latest` slots of `--out_dir`, with fresh AdamW state and the meta of the
port's trainer (epoch 0), so that `python -m ultrafnd_git_tpu_torch.train
--resume` fine-tunes it from epoch 1, `--eval_only` evaluates it, and
`Predictor(out_dir=O)` / `predict` / `serve --out_dir O` serve it. The
port's fusion, classifier and GCN carry the reference's key names
(`utils/transfer.port_state_dicts_from_best_pt`), so the load is strict
but for the reference fusion's zero-filled `semantic.*` projections, which
no fusion forward reads.

* The trainer builds its feature cache and OCR graph over `--data_root`
  (the checkpoint carries none), or takes `--model_dir`'s cache and align
  weights as `train --model_dir` does. A checkpoint trained on the
  reference's features is best paired with encoder rungs whose
  featurization agrees with the reference's.
* The fields that shape the parameters (gnn_dim, use_gnn) and the
  optimizer's hyperparameters come from the checkpoint's embedded cfg;
  the paths come from the command line.
* The device is cuda unless --device cpu (or --cpu) asks for the CPU;
  without a GPU, cuda raises.
"""
from __future__ import annotations

import argparse
import pickle
from dataclasses import asdict
from pathlib import Path

from ultrafnd_git_tpu_torch.utils.device import add_device_args, resolve_cpu_flag


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        description="Import a reference best.pt into a best/latest slot of the port")
    ap.add_argument("best_pt", type=str, help="path to the reference best.pt")
    ap.add_argument("--data_root", type=str, required=True)
    ap.add_argument("--out_dir", type=str, required=True)
    ap.add_argument("--ocr_phrase_pkl", type=str, default=None)
    ap.add_argument("--model_dir", type=str, default=None,
                    help="model dir whose feature_cache.npz (and align weights) the "
                         "slot takes instead of building one from --data_root")
    ap.add_argument("--eval", action="store_true",
                    help="run test() on the imported checkpoint and print metrics")
    add_device_args(ap)
    return resolve_cpu_flag(ap.parse_args(argv))


def load_best_pt(path: str):
    import torch

    try:
        return torch.load(path, map_location="cpu", weights_only=True)
    except (TypeError, pickle.UnpicklingError) as e:
        # a torch without weights_only, or leaves the safe unpickler refuses;
        # anything else (a corrupt file, IO) propagates. The full unpickler
        # runs the file's pickle program: import only checkpoints you trust.
        print(
            f"warning: safe (weights_only) load failed ({e}); retrying "
            "with the full unpickler — only do this for trusted files"
        )
        return torch.load(path, map_location="cpu", weights_only=False)


def main(argv=None) -> int:
    args = parse_args(argv)
    payload = load_best_pt(args.best_pt)
    for key in ("fusion", "clf"):
        if key not in payload:
            print(f"error: {args.best_pt} has no '{key}' state dict — "
                  "not a reference v2 best.pt")
            return 2
    ref_cfg = dict(payload.get("cfg") or {})

    from ultrafnd_git_tpu_torch.training import checkpoint as ckpt
    from ultrafnd_git_tpu_torch.training.loop import np_random_state_payload
    from ultrafnd_git_tpu_torch.training.trainer import (
        TRAINER_KIND,
        ForensicTrainer,
        TrainConfig,
    )
    from ultrafnd_git_tpu_torch.utils.transfer import port_state_dicts_from_best_pt

    ocr_pkl = args.ocr_phrase_pkl
    if ocr_pkl is None:
        ref_pkl = ref_cfg.get("ocr_phrase_pkl")
        if ref_pkl and Path(ref_pkl).exists():
            ocr_pkl = ref_pkl
        elif ref_pkl:
            print(f"note: checkpoint's ocr_phrase_pkl {ref_pkl!r} not found "
                  "locally; building OCR sets from the metadata JSON")

    cfg = TrainConfig(
        data_root=args.data_root,
        ocr_phrase_pkl=ocr_pkl,
        out_dir=args.out_dir,
        model_dir=args.model_dir,
        batch_size=int(ref_cfg.get("batch_size", 16)),
        epochs=0,
        lr=float(ref_cfg.get("lr", 2e-4)),
        weight_decay=float(ref_cfg.get("weight_decay", 1e-4)),
        gnn_dim=int(ref_cfg.get("gnn_dim", 128)),
        gnn_overlap_thresh=float(ref_cfg.get("gnn_overlap_thresh", 0.12)),
        seed=int(ref_cfg.get("seed", 42)),
        use_gnn=bool(ref_cfg.get("use_gnn", True)),
        grad_clip=float(ref_cfg.get("grad_clip", 5.0)),
        early_stop_patience=int(ref_cfg.get("early_stop_patience", 3)),
    )

    print(f"building feature cache + graph from {args.data_root} ...")
    trainer = ForensicTrainer(cfg, device=args.device)

    imported = port_state_dicts_from_best_pt(payload)
    if "gnn" not in imported and cfg.use_gnn:
        # the reference writes gnn=None under use_gnn=False only
        print("note: checkpoint has no GNN weights; keeping the local "
              "degree-recon pretrained GCN")

    # the shapes against the trainer's modules before anything is written
    modules = trainer.state.params
    for part, sd in imported.items():
        if part not in modules:
            print(f"error: imported subtree {part!r} not in the local "
                  f"param pytree {sorted(modules)}")
            return 2
        ours = {k: tuple(v.shape) for k, v in modules[part].state_dict().items()}
        theirs = {k: tuple(v.shape) for k, v in sd.items()}
        if ours != theirs:
            only_t = {k: v for k, v in ours.items() if theirs.get(k) != v}
            only_i = {k: v for k, v in theirs.items() if ours.get(k) != v}
            print(f"error: {part} parameter shapes differ "
                  f"(local {only_t} vs checkpoint {only_i}) — was the "
                  "checkpoint trained with different gnn_dim/use_gnn?")
            return 2
    for part, sd in imported.items():
        modules[part].load_state_dict(sd)

    meta = {
        "trainer": TRAINER_KIND,
        "epoch": 0,
        "best_val_auc": -1.0,  # unknown: the reference stores no metric
        "no_improve": 0,
        "cfg": asdict(cfg),
        "np_random_state": np_random_state_payload(),
        "model": trainer.model_meta,
        "imported_from": str(Path(args.best_pt).resolve()),
    }
    ckpt.save_checkpoint(cfg.out_dir, "best", trainer.state, meta)
    # `latest` too: --resume restores that slot; epoch 0 resumes at epoch 1
    ckpt.save_checkpoint(cfg.out_dir, "latest", trainer.state, meta)
    print(f"imported {args.best_pt} -> {cfg.out_dir}/{{best,latest}} "
          f"(fusion+clf{'+gnn' if 'gnn' in imported else ''})")
    print("consume it with: python -m ultrafnd_git_tpu_torch.train --eval_only or "
          "--resume, or python -m ultrafnd_git_tpu_torch.predict / serve "
          f"--out_dir {cfg.out_dir}")

    if args.eval:
        metrics = trainer.test()
        print({k: round(v, 4) for k, v in metrics.items()})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
