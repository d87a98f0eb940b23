"""Train and test with the port (counterpart of run_train_eval.py).

    python -m ultrafnd_git_tpu_torch.train --data_root R --out_dir O \
        [--use_evidence] [--ocr_phrase_pkl P] [--epochs 12] [--batch_size 16] \
        [--train_text_tower [--moe_experts E] [--remat_tower]] [--fused_adamw] \
        [--sparse_graph] [--bf16] [--hash_salt S | --auto_salt a,b] [--resume] \
        [--save_every_steps K] [--profile_dir P] [--debug_nans] [--model_dir D] \
        [--dp N] [--tp N] [--dcn N] [--sp N | --pp N [--pp_microbatches M]] \
        [--shard_corpus] [--shard_graph] [--multihost] \
        [--trainer v2|integrated] [--device cuda|cpu | --cpu] [--export_model_dir M]

The run's feature cache is out_dir's own when it has a usable one, else
that of `--model_dir` (a model directory from
`scripts/export_torch_model.py` or from `--export_model_dir`), else it is
built from the raw FakeSV `--data_root` (its data_complete.json), with its
align pass on the device. `--export_model_dir` writes the trained `best`
slot, with the align MLP its cache was built with, as a model directory
that `python -m ultrafnd_git_tpu_torch.predict` serves. The device defaults
to cuda and raises when there is no GPU; pass --device cpu (or
run_train_eval.py's --cpu) to run on the CPU. `--no_scan_epoch` and
`--no_fast_dropout_rng` are accepted as run_train_eval.py accepts them and
have no effect (the TrainConfig fields they set have none in the port).
`--auto_salt` trains one run per candidate salt from `--data_root`
(`training/salt_search.py`), adopts the winner's artifacts into out_dir and
tests its best slot. Prints the `==== Final Results ====` block of
run_train_eval.py.

The mesh flags are run_train_eval.py's. A mesh of N ranks is N processes
of this CLI, one a rank: `--multihost` joins them through
`torch.distributed` from JAX_COORDINATOR_ADDRESS (host:port),
JAX_NUM_PROCESSES and JAX_PROCESS_ID, the JAX package's env contract
(NCCL on the GPU, rank r on cuda:<local rank>; gloo with --device cpu).
Rank 0 writes the out_dir's files; every rank prints the same results. A
mesh of one rank needs no launcher (`--dp 1`). `--sp N` (ring attention
over the tower's sequence) and `--pp N` (GPipe over its blocks,
`--pp_microbatches M` of them a step, default N) need
`--train_text_tower` and compose with `--dp` and `--tp`: the world is
dp * tp * N ranks.

`--trainer integrated` trains the integrated variant instead
(`training/trainer_integrated.py`: per-batch annealed OCR-Jaccard graphs,
GNNModel, label smoothing, cosine LR) from the same cache ladder and the
flags run_train_eval.py passes it; the flags of its list that apply to the
v2 trainer only are ignored with its warning. Its checkpoints cannot be
served, so it refuses `--export_model_dir`.
"""
from __future__ import annotations

import argparse
from pathlib import Path

from ultrafnd_git_tpu_torch.utils.device import add_device_args, resolve_cpu_flag


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="ultrafnd_git_tpu_torch v2 — train/test")
    p.add_argument("--data_root", type=str, default="data/FakeSV",
                   help="Root with videos/, video_comment/, data_complete.json")
    p.add_argument("--ocr_phrase_pkl", type=str,
                   default="fakesv/preprocess_ocr/ocr_phrase_fea.pkl",
                   help="OCR phrase cache from scripts/generate_ocr_phrase_features.py "
                        "(optional; whitespace tokenization is used if missing).")
    p.add_argument("--model_dir", default=None,
                   help="model dir whose feature_cache.npz (and align weights) the "
                        "run takes instead of building one from --data_root")
    p.add_argument("--out_dir", default="outputs_v2",
                   help="Where to save checkpoints & logs")
    p.add_argument("--epochs", type=int, default=12)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--weight_decay", type=float, default=1e-4)
    p.add_argument("--gnn_dim", type=int, default=128)
    p.add_argument("--gnn_overlap_thresh", type=float, default=0.12)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--no_gnn", action="store_true", help="Disable GNN features")
    p.add_argument("--use_evidence", action="store_true",
                   help="Feed real evidence-scorer outputs (semantic gap, "
                        "emotion intensity, temporal delay) into the fusion "
                        "evidence gates instead of the internal proxies")
    p.add_argument("--freeze_gnn", action="store_true",
                   help="Keep the GCN frozen after its degree-recon pretrain")
    p.add_argument("--sparse_graph", action="store_true",
                   help="the corpus graph as padded (N, K) neighbour lists: "
                        "no (N, N) adjacency is built")
    p.add_argument("--grad_accum", type=int, default=1)
    p.add_argument("--fused_adamw", action="store_true",
                   help="accepted for run_train_eval.py parity; no effect: "
                        "AdamW always runs as one K1 launch per step on CUDA")
    p.add_argument("--train_text_tower", action="store_true")
    p.add_argument("--text_tower_depth", type=int, default=2)
    p.add_argument("--text_tower_heads", type=int, default=6)
    p.add_argument("--tower_gelu", choices=("tanh", "exact"), default="tanh")
    p.add_argument("--moe_experts", type=int, default=0,
                   help="Swap the --train_text_tower MLPs for a switch "
                        "(top-1) mixture-of-experts FFN with this many "
                        "experts; Switch aux losses fold into the loss "
                        "(--moe_aux_weight)")
    p.add_argument("--moe_aux_weight", type=float, default=1e-2,
                   help="Weight of the Switch load-balance + z aux loss")
    p.add_argument("--remat_tower", action="store_true",
                   help="Rematerialize tower blocks on the backward pass "
                        "(torch.utils.checkpoint): less live device memory "
                        "for one more forward of each block per step; the "
                        "same bits as without it")
    p.add_argument("--bf16", action="store_true",
                   help="bf16 matmul activations with f32 master params "
                        "(single MXU pass; numerics within the bf16 "
                        "envelope); on a GPU the tower's attention runs the "
                        "bf16 modes of the flash-attention kernels")
    p.add_argument("--hash_salt", type=str, default="",
                   help="Salt for every stable-hash featurization (offline "
                        "hash embeddings, proxies, tower token ids). The "
                        "hash features are a random projection whose "
                        "collision draw measurably moves acc/F1 "
                        "(BASELINE.md accuracy-parity notes); the salt "
                        "makes the draw tunable like a seed. Recorded in "
                        "the cache fingerprint + checkpoint; eval/serving "
                        "adopt it automatically. A cache taken from "
                        "--model_dir brings its own salt, which is adopted")
    p.add_argument("--select_metric", default="auc",
                   choices=("auc", "acc", "f1", "precision", "recall"))
    p.add_argument("--auto_salt", type=str, default=None,
                   help="Comma-separated candidate hash salts: train one "
                        "full run per candidate (plus the unsalted "
                        "baseline; an explicit --hash_salt is a candidate "
                        "too) from --data_root, select the winner by best "
                        "VALIDATION --select_metric, adopt its checkpoints, "
                        "cache and align weights into out_dir and test its "
                        "best slot (BASELINE.md 'Tuning the draw')")
    p.add_argument("--resume", action="store_true",
                   help="Resume from the latest checkpoint in out_dir")
    p.add_argument("--save_every_steps", type=int, default=0,
                   help="Also write the `latest` checkpoint every K "
                        "optimizer steps, so a mid-epoch preemption "
                        "resumes from the last K-step boundary instead of "
                        "replaying the whole epoch; --resume then lands "
                        "bit-identical to an uninterrupted run (the "
                        "mid-epoch meta records step cursor, batch order "
                        "and shuffle stream). 0 = per-epoch only")
    p.add_argument("--profile_dir", type=str, default=None,
                   help="Write a torch.profiler trace of fit() here "
                        "(fit.trace.json, Chrome trace format), with the "
                        "program's spans on a track of their own")
    p.add_argument("--debug_nans", action="store_true",
                   help="Raise FloatingPointError at the first step whose "
                        "loss, outputs or gradients hold a NaN (autograd "
                        "anomaly mode around the backward; one device sync "
                        "a step)")
    p.add_argument("--eval_only", action="store_true",
                   help="Skip training; load best and test")
    p.add_argument("--trainer", choices=("v2", "integrated"), default="v2",
                   help="v2 = canonical cache trainer (transductive GCN); "
                        "integrated = per-batch annealed OCR-Jaccard graphs, "
                        "GNNModel, label smoothing, cosine LR")
    p.add_argument("--no_scan_epoch", action="store_true",
                   help="accepted for run_train_eval.py parity; no effect: the "
                        "port dispatches one step per Python call")
    p.add_argument("--no_fast_dropout_rng", action="store_true",
                   help="accepted for run_train_eval.py parity; no effect: the "
                        "port draws dropout masks from one torch.Generator")
    p.add_argument("--dp", type=int, default=None,
                   help="Data-parallel mesh size (default: no mesh)")
    p.add_argument("--tp", type=int, default=1, help="Tensor-parallel mesh size")
    p.add_argument("--dcn", type=int, default=1,
                   help="Outer data-parallel mesh axis (groups of ranks across "
                        "nodes): batches split over (dcn, data) jointly and the "
                        "gradient sum crosses it once a step (composes with "
                        "--dp/--tp)")
    p.add_argument("--sp", type=int, default=1,
                   help="Sequence-parallel mesh size: ring attention over the "
                        "--train_text_tower sequence axis (composes with --dp/--tp)")
    p.add_argument("--pp", type=int, default=1,
                   help="Pipeline-parallel mesh size: GPipe schedule over the "
                        "--train_text_tower block stack (composes with --dp/--tp)")
    p.add_argument("--pp_microbatches", type=int, default=None,
                   help="GPipe microbatches per step (default: --pp)")
    p.add_argument("--shard_corpus", action="store_true",
                   help="Split the device-resident feature corpus rows over the "
                        "data mesh axes")
    p.add_argument("--shard_graph", action="store_true",
                   help="Split the (N, N) GCN adjacency rows (or the "
                        "--sparse_graph neighbour lists) over the data mesh axes")
    p.add_argument("--multihost", action="store_true",
                   help="Join the processes of a mesh before any device use "
                        "(reads JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / "
                        "JAX_PROCESS_ID; no-op when they are unset)")
    add_device_args(p)
    p.add_argument("--export_model_dir", default=None,
                   help="write the best slot here as a servable model dir")
    return resolve_cpu_flag(p.parse_args(argv))


# run_train_eval.py's list of flags the integrated trainer ignores
V2_ONLY = (
    ("--train_text_tower", lambda a: a.train_text_tower),
    ("--dp", lambda a: a.dp is not None),
    ("--tp", lambda a: a.tp > 1),
    ("--dcn", lambda a: a.dcn > 1),
    ("--shard_corpus", lambda a: a.shard_corpus),
    ("--shard_graph", lambda a: a.shard_graph),
    ("--sparse_graph", lambda a: a.sparse_graph),
    ("--freeze_gnn", lambda a: a.freeze_gnn),
    ("--no_fast_dropout_rng", lambda a: a.no_fast_dropout_rng),
    ("--select_metric", lambda a: a.select_metric != "auc"),
    ("--auto_salt", lambda a: bool(a.auto_salt)),
    ("--grad_accum", lambda a: a.grad_accum > 1),
    ("--sp", lambda a: a.sp > 1),
    ("--pp", lambda a: a.pp > 1),
    ("--moe_experts", lambda a: a.moe_experts > 0),
)


def main_integrated(args, data_root: Path, ocr_pkl: Path, out_dir: Path) -> dict:
    """The `--trainer integrated` branch of run_train_eval.py."""
    from ultrafnd_git_tpu_torch.training.trainer_integrated import (
        IntegratedForensicTrainer,
        IntegratedTrainConfig,
    )

    if args.export_model_dir:
        raise SystemExit("--export_model_dir: a checkpoint of the integrated trainer "
                         "cannot be served (serving.Predictor takes v2 checkpoints only)")
    ignored = [flag for flag, on in V2_ONLY if on(args)]
    if ignored:
        print(f"⚠️  {' '.join(ignored)} apply to the v2 trainer only; "
              "the integrated trainer ignores them")
    icfg = IntegratedTrainConfig(
        data_root=str(data_root),
        ocr_phrase_pkl=str(ocr_pkl) if ocr_pkl.exists() else None,
        out_dir=str(out_dir),
        model_dir=args.model_dir,
        batch_size=args.batch_size,
        epochs=args.epochs,
        lr=args.lr,
        weight_decay=args.weight_decay,
        gnn_dim=args.gnn_dim,
        gnn_overlap_thresh=args.gnn_overlap_thresh,
        seed=args.seed,
        use_gnn=not args.no_gnn,
        use_evidence=args.use_evidence,
        profile_dir=args.profile_dir,
        scan_epoch=not args.no_scan_epoch,
        bf16_compute=args.bf16,
        resume=args.resume,
        hash_salt=args.hash_salt,
    )
    trainer = IntegratedForensicTrainer(icfg, device=args.device)
    results = trainer.test() if args.eval_only else trainer.train()
    print("\n==== Final Results ====")
    for k, v in results.items():
        print(f"{k.replace('test_', 'Test ').title()}: {v:.4f}")
    return results


def main(argv=None) -> dict:
    args = parse_args(argv)
    from ultrafnd_git_tpu_torch.training.checkpoint import is_primary
    from ultrafnd_git_tpu_torch.training.trainer import ForensicTrainer, TrainConfig

    world = 1
    if args.multihost:
        import torch.distributed as dist

        from ultrafnd_git_tpu_torch.parallel.mesh import maybe_initialize_distributed

        if maybe_initialize_distributed(backend="gloo" if args.device == "cpu" else "nccl"):
            world = dist.get_world_size()
            print(f"multi-host: process {dist.get_rank()} of {world}")
        else:
            print("multi-host: no coordinator configured — single process")

    out_dir = Path(args.out_dir).expanduser()
    out_dir.mkdir(parents=True, exist_ok=True)
    data_root = Path(args.data_root).expanduser()
    ocr_pkl = Path(args.ocr_phrase_pkl).expanduser()
    if args.trainer == "integrated":
        print("==== ultrafnd_git_tpu_torch integrated ====")
        print(f"Device:          {args.device}")
        print(f"Data root:       {data_root}")
        print(f"Output dir:      {out_dir}")
        print(f"Epochs:          {args.epochs}")
        print(f"Batch size:      {args.batch_size}")
        print(f"Use GNN:         {not args.no_gnn}")
        print(f"GNN overlap thr: {args.gnn_overlap_thresh}")
        print("=============================")
        return main_integrated(args, data_root, ocr_pkl, out_dir)
    cfg = TrainConfig(
        data_root=str(data_root),
        ocr_phrase_pkl=str(ocr_pkl) if ocr_pkl.exists() else None,
        out_dir=str(out_dir),
        model_dir=args.model_dir,
        batch_size=args.batch_size,
        epochs=args.epochs,
        lr=args.lr,
        weight_decay=args.weight_decay,
        gnn_dim=args.gnn_dim,
        gnn_overlap_thresh=args.gnn_overlap_thresh,
        seed=args.seed,
        use_gnn=not args.no_gnn,
        use_evidence=args.use_evidence,
        train_gnn=not args.freeze_gnn,
        sparse_graph=args.sparse_graph,
        grad_accum=args.grad_accum,
        fused_adamw=args.fused_adamw,
        train_text_tower=args.train_text_tower,
        text_tower_depth=args.text_tower_depth,
        text_tower_heads=args.text_tower_heads,
        tower_gelu=args.tower_gelu,
        moe_experts=args.moe_experts,
        moe_aux_weight=args.moe_aux_weight,
        remat_tower=args.remat_tower,
        bf16_compute=args.bf16,
        scan_epoch=not args.no_scan_epoch,
        fast_dropout_rng=not args.no_fast_dropout_rng,
        hash_salt=args.hash_salt,
        select_metric=args.select_metric,
        resume=args.resume,
        save_every_steps=args.save_every_steps,
        eval_only=args.eval_only,
        profile_dir=args.profile_dir,
        debug_nans=args.debug_nans,
        dp=args.dp,
        tp=args.tp,
        dcn=args.dcn,
        sp=args.sp,
        pp=args.pp,
        pp_microbatches=args.pp_microbatches,
        shard_corpus=args.shard_corpus,
        shard_graph=args.shard_graph,
    )
    print("==== ultrafnd_git_tpu_torch v2 ====")
    print(f"Device:          {args.device}")
    print(f"Data root:       {data_root}")
    print(f"Model dir:       {args.model_dir}")
    print(f"Output dir:      {out_dir}")
    print(f"Epochs:          {args.epochs}")
    print(f"Batch size:      {args.batch_size}")
    print(f"Use GNN:         {not args.no_gnn}")
    print(f"Use evidence:    {args.use_evidence}")
    print(f"bf16 compute:    {args.bf16}")
    print("=============================")
    extra = None
    if args.auto_salt:
        if world > 1:
            raise SystemExit("--auto_salt trains its candidate runs in one process; "
                             "it cannot run over a multi-process mesh")
        if args.eval_only or args.resume:
            raise SystemExit("--auto_salt trains fresh candidate runs; it cannot be "
                             "combined with --eval_only or --resume")
        if args.model_dir:
            raise SystemExit("--auto_salt featurizes the corpus anew under each "
                             "candidate salt from --data_root; it cannot take "
                             "--model_dir's cache")
        import dataclasses

        from ultrafnd_git_tpu_torch.training.salt_search import (
            parse_salt_list,
            search_hash_salt,
        )

        candidates = parse_salt_list(args.auto_salt)
        if args.hash_salt and args.hash_salt not in candidates:
            candidates.insert(0, args.hash_salt)
        winner, _ = search_hash_salt(cfg, candidates, device=args.device)
        # out_dir now holds the winner's artifacts: score its best slot as a
        # direct `--hash_salt <winner> --eval_only` run would
        cfg = dataclasses.replace(cfg, hash_salt=winner, eval_only=True)
        trainer = ForensicTrainer(cfg, device=args.device)
        print("\n>>> Testing best checkpoint (auto_salt winner)...")
        extra = f"Selected hash_salt: {winner!r}"
    else:
        trainer = ForensicTrainer(cfg, device=args.device)
        if not args.eval_only:
            print("\n>>> Training...")
            trainer.fit()
        print("\n>>> Testing best checkpoint...")
    results = trainer.test()
    print("\n==== Final Results ====")
    if extra:
        print(extra)
    print(f"Test Loss: {results['test_loss']:.4f}")
    print(f"Test Acc : {results['test_acc']:.4f}")
    print(f"Test AUC : {results['test_auc']:.4f}")
    for k in ("test_precision", "test_recall", "test_f1", "test_cmcs", "test_dfdr"):
        print(f"{k.replace('test_', 'Test ').title()}: {results[k]:.4f}")
    if args.export_model_dir and is_primary():
        from ultrafnd_git_tpu_torch.utils.transfer import export_trained

        root = export_trained(str(out_dir), "best", args.export_model_dir, args.model_dir)
        print(f"wrote {root}")
    return results


if __name__ == "__main__":
    main()
