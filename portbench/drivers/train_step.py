"""Driver of the v2 trainer's step: `ForensicTrainer.train_step` over
`epoch_batches(tr_idx, True)`, back to back.

Set-up builds one trainer over the configuration's synthetic corpus
(injected, `cache_to_disk=False`), loads the benchmark's weights over its
own, and drives it through `checked_steps` steps of the window's own call
and feed (rows that all differ), recording each step's loss, the dropout
masks it draws (every `Tensor.bernoulli_` of the step, in order), the AdamW
first moment after the first step and the parameters after the last. The
window then steps the same trainer until `--seconds` have passed and the
device has drained. Once it has closed, the trainer is freed and the plain
reference (`reference/fnd_v2_step.py`) steps the same weights, rows and
masks; the numbers compared are the worst step's loss gap, and leaf by
leaf the gap of the first gradient's norm (the program's read from its
first moment) and of the parameters' change over the checked steps, each
at the median leaf and at the worst.
"""
from __future__ import annotations

import gc
import math
import sys
import tempfile
import time
from pathlib import Path
from typing import Any, Dict, Iterator, List

import numpy as np
import torch
from torch.overrides import TorchFunctionMode

from portbench import check, weights
from portbench.corpus import make_corpus
from portbench.flops import fnd_tower as flops
from portbench.reference import fnd_v2_step as ref
from portbench.window import drive, peak_bytes, sync


class MaskRecorder(TorchFunctionMode):
    """Every `Tensor.bernoulli_` drawn under it, as a bool tensor."""

    def __init__(self):
        super().__init__()
        self.masks: List[torch.Tensor] = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func is torch.Tensor.bernoulli_:
            self.masks.append(out.detach().bool())
        return out


def _write_yaml(path: Path, values: Dict[str, Any]) -> str:
    lines = [f"{k}: {str(v).lower() if isinstance(v, bool) else v}" for k, v in values.items()]
    path.write_text("\n".join(lines) + "\n", encoding="utf-8")
    return str(path)


def _train_config(cfg: Dict[str, Any], traffic: Dict[str, Any], seed: int, work: Path):
    from ultrafnd_git_tpu_torch.data.cache import TOWER_VOCAB
    from ultrafnd_git_tpu_torch.training.trainer import TrainConfig

    t, f, c, g, o = (cfg[k] for k in ("tower", "fusion", "classifier", "gnn", "optimizer"))
    if t["vocab_size"] != TOWER_VOCAB or t["max_len"] != cfg["corpus"]["ids_len"]:
        raise ValueError("the trainer's tower vocabulary and length are the cache's")
    fusion = _write_yaml(work / "fusion.yaml", {"hidden_dim": f["hidden"], "dropout": f["dropout"],
                                                "use_gnn": f["use_gnn"]})
    clf = _write_yaml(work / "classifier.yaml", {
        "hidden_dim": c["hidden"], "dropout": c["dropout"], "num_classes": c["num_classes"],
        "use_aux": c["use_aux"], "aux_dim": c["aux_dim"], "node_trees": c["node_trees"],
        "node_depth": c["node_depth"], "node_tau": c["node_tau"],
        "node_dropout": c["node_dropout"], "temperature": c["temperature"]})
    return TrainConfig(
        out_dir=str(work / "out"), batch_size=traffic["batch_size"], seed=seed % 2 ** 32,
        lr=o["lr"], weight_decay=o["weight_decay"], grad_clip=o["grad_clip"],
        gnn_dim=g["dim"], gnn_overlap_thresh=g["overlap_thresh"], use_gnn=f["use_gnn"],
        train_text_tower=True, text_tower_depth=t["depth"], text_tower_heads=t["heads"],
        tower_gelu=t["gelu"], cache_to_disk=False, save_best=False, log_metrics_jsonl=False,
        fusion_config=fusion, classifier_config=clf)


def _load_weights(trainer, spec, drawn) -> None:
    """The benchmark's weights into the trainer's leaves; the trainer's
    leaves must be the spec's, name for name and shape for shape."""
    params = trainer.state.params
    if set(params) != set(spec) or set(trainer.trainable()) != set(spec):
        raise ValueError(f"the trainer trains {sorted(trainer.trainable())}, the spec "
                         f"{sorted(spec)}")
    with torch.no_grad():
        for part, leaves in spec.items():
            own = dict(params[part].named_parameters())
            want = {name: shape for name, shape, _, _ in leaves}
            if {k: tuple(v.shape) for k, v in own.items()} != want:
                raise ValueError(f"the trainer's {part} leaves differ from the spec's")
            for name, p in own.items():
                p.copy_(drawn[part][name])


def _batches(trainer) -> Iterator:
    while True:  # an epoch at a time, one shuffle each
        yield from trainer.epoch_batches(trainer.tr_idx, True)


def _host(tree: Dict[str, Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    return {f"{part}.{name}": t.detach().to("cpu", copy=True)
            for part, leaves in tree.items() for name, t in leaves.items()}


def compare(losses, grad1, params, w0, r) -> Dict[str, Any]:
    """The numbers compared of a program's (or the control's) losses, first
    gradient and parameters against the reference's run `r` from the
    weights `w0` (leaves `part.name`), with the worst leaves beside them.

    The worst leaf's limits leave room for the subgradient of |t - v| and
    |t - a| (the fusion's pair features), which the two sides take on
    opposite sides of the kink where those differences round to within
    1e-7 of zero (PERF.md)."""
    loss = max(check.finite_or_inf(abs(a - b) / max(abs(b), 1e-30))
               for a, b in zip(losses, r["losses"]))
    g_med, g_worst, g_leaf = check.median_and_worst(
        check.leaf_norm_gaps(grad1, {k: v.cpu() for k, v in r["grad1"].items()}))
    moving = check.moving_leaves(r["grad1"])
    dp = {k: params[k].cpu() - w0[k] for k in moving}
    dr = {k: r["params"][k].cpu() - w0[k] for k in moving}
    c_med, c_worst, c_leaf = check.median_and_worst(check.leaf_norm_gaps(dp, dr, moving))
    return {"numbers": {"loss": loss, "grad1_median": g_med, "grad1_worst": g_worst,
                        "change3_median": c_med, "change3_worst": c_worst},
            "worst": {"grad1": g_leaf, "change3": c_leaf},
            "left_out": sorted(set(r["grad1"]) - set(moving))}


def run(ctx) -> Dict[str, Any]:
    cfg, traffic = ctx.cfg, ctx.traffic
    dev = torch.device(ctx.device)
    batch = traffic["batch_size"]
    stamps = {"start": time.perf_counter() - ctx.t0}
    corpus = make_corpus(cfg, ctx.seed)
    stamps["corpus"] = time.perf_counter() - ctx.t0
    from ultrafnd_git_tpu_torch.training.trainer import ForensicTrainer

    # the module YAMLs and an out_dir the trainer writes nothing to (no fit,
    # no cache on disk), gone once it is built
    with tempfile.TemporaryDirectory(prefix="portbench-train-") as work:
        trainer = ForensicTrainer(_train_config(cfg, traffic, ctx.seed, Path(work)), cache=corpus,
                                  device=ctx.device)
    stamps["trainer"] = time.perf_counter() - ctx.t0
    spec = ref.param_spec(cfg)
    drawn = weights.draw(spec, ctx.seed, dev)
    _load_weights(trainer, spec, drawn)
    del drawn
    stamps["weights"] = time.perf_counter() - ctx.t0
    for mod in trainer.state.params.values():
        mod.train(True)
    feed = _batches(trainer)

    # the checked steps: the window's own call and feed, recorded
    checked, masks, losses = [], [], []
    mu1 = None
    for i in range(traffic["checked_steps"]):
        chunk, mask, _ = next(feed)
        rec = MaskRecorder()
        with rec:
            loss, _, _ = trainer.train_step(chunk, mask)
        losses.append(float(loss.detach()))
        masks.append([m.cpu() for m in rec.masks])
        checked.append((np.array(chunk), np.array(mask)))
        if i == 0:
            mu1 = _host(trainer.state.opt_state["mu"])
    params = _host({p: dict(m.named_parameters()) for p, m in trainer.state.params.items()})
    sync(dev)
    setup_peak = peak_bytes(dev)
    setup_s = time.perf_counter() - ctx.t0
    stamps["checked_steps"] = setup_s
    print(f"train_step: set-up reached, s after the start: {stamps}", file=sys.stderr)

    # the window
    step_flops = flops.step_flops(cfg, batch)
    shapes = flops.attention_shapes(cfg, batch)

    def step(_):
        chunk, mask, valid = next(feed)
        t0 = time.perf_counter()
        trainer.train_step(chunk, mask)
        return {"t0": t0, "t1": time.perf_counter(), "rows": int(valid), "flops": step_flops,
                "attn_fwd": shapes, "attn_bwd": shapes}

    units, window_s, window_peak, traced = drive(dev, ctx.seconds, ctx.trace,
                                                 traffic["host_units"], step)
    rec = {"setup_s": setup_s, "window_s": window_s, "units": units,
           "trace": traced,
           "memory": {"window_peak_bytes": window_peak, "setup_peak_bytes": setup_peak},
           "cfg": cfg}
    steps_per_epoch = math.ceil(len(trainer.tr_idx) / batch)
    b1 = trainer.tx.b1

    # the program is freed before the reference runs
    del trainer, feed, step
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    omb1 = float(np.float32(1 - b1))
    grad1 = {k: v / omb1 for k, v in mu1.items()}
    w0 = weights.draw(spec, ctx.seed, dev)
    w0_host = _host(w0)
    r = ref.run_steps(cfg, corpus, w0, checked, masks, steps_per_epoch, dev)
    got = compare(losses, grad1, params, w0_host, r)
    print(f"train_step: losses {losses} reference {r['losses']}; worst leaves "
          f"{got['worst']}; left out of the change (no gradient in the reference): "
          f"{got['left_out']}", file=sys.stderr)
    out = {"rec": rec, "numbers": got["numbers"], "attempted": len(units), "failed": 0,
           "memory_peak_bytes": max(setup_peak, window_peak)}
    if ctx.control:
        rc = ref.run_steps(cfg, corpus, w0, checked, masks, steps_per_epoch, dev, tf32=True)
        out["control"] = compare(rc["losses"], {k: v.cpu() for k, v in rc["grad1"].items()},
                                 {k: v.cpu() for k, v in rc["params"].items()}, w0_host,
                                 r)["numbers"]
    return out
