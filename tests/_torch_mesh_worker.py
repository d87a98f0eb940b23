"""One rank of the port's mesh tests, run as a script: `python
tests/_torch_mesh_worker.py JOB.json`, with JAX_COORDINATOR_ADDRESS,
JAX_NUM_PROCESSES and JAX_PROCESS_ID set (the port's `--multihost`
contract). It joins the gloo world through
`parallel.mesh.maybe_initialize_distributed`, runs the job's cases in
order and writes each case's result to `<out>/<case>.rank<r>.pt`. It loads
no module of jax or of the JAX package (the result records
`sys.modules`).

The tests import `mesh_cache`, `small_configs` and `run_trainer_case` from
here, so that the one-device references run the same code in the test
process.
"""
from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

# small module widths for the mesh trainer cases (flat YAML, read by both
# packages' trainers)
FUSION_YAML = "hidden_dim: 64\ndropout: 0.1\nuse_gnn: true\ngnn_dim: 16\n"
CLASSIFIER_YAML = ("input_dim: 64\nhidden_dim: 64\ndropout: 0.1\nnum_classes: 2\n"
                   "use_aux: true\naux_dim: 2\nnode_trees: 2\nnode_depth: 2\n"
                   "node_tau: 10.0\ntemperature: 1.0\n")


def small_configs(root: Path) -> dict:
    """Write the small fusion / classifier configs under `root`; the
    TrainConfig fields that read them."""
    root.mkdir(parents=True, exist_ok=True)
    (root / "fusion.yaml").write_text(FUSION_YAML)
    (root / "classifier.yaml").write_text(CLASSIFIER_YAML)
    return {"fusion_config": str(root / "fusion.yaml"),
            "classifier_config": str(root / "classifier.yaml"), "gnn_dim": 16}


def mesh_cache(n: int = 48, width: int = 32, seq: int = 8, seed: int = 0) -> dict:
    """A synthetic feature cache (the shape of the trainer's) with narrow
    text rows and short token rows."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, 400, size=(n, seq)).astype(np.int32)
    lengths = rng.integers(2, seq + 1, size=n)
    mask = (np.arange(seq)[None] < lengths[:, None]).astype(np.float32)
    order = rng.permutation(n)
    return {
        "ids": [f"r{i}" for i in range(n)],
        "labels": (np.arange(n) % 2).astype(np.int64),
        "text": rng.standard_normal((n, width)).astype(np.float32),
        "audio": rng.standard_normal((n, 128)).astype(np.float32),
        "visual": rng.standard_normal((n, 512)).astype(np.float32),
        "temporal": rng.standard_normal((n, 256)).astype(np.float32),
        "aux": rng.uniform(size=(n, 2)).astype(np.float32),
        "evidence": rng.uniform(size=(n, 3)).astype(np.float32),
        "text_ids": ids * mask.astype(np.int32),
        "text_mask": mask,
        "ocr_sets": [set(f"t{j}" for j in rng.choice(24, 4, replace=False)) for _ in range(n)],
        "split": (np.sort(order[: n * 2 // 3]), np.sort(order[n * 2 // 3: n * 5 // 6]),
                  np.sort(order[n * 5 // 6:])),
    }


def run_trainer_case(case: dict) -> dict:
    """Build a trainer from `case["cfg"]` on `mesh_cache(**case["cache"])`
    (carrying `case["params"]`'s full state dicts when given), take its val
    loss and metrics, then `case["steps"]` train steps with dropout on; the
    result holds the global losses, the clip's global norm of each step,
    the val metrics, the full parameters after the steps (gathered from tp
    shards), this rank's own parameters and the row counts of its corpus
    arrays."""
    from ultrafnd_git_tpu_torch.kernels.adamw import AdamW
    from ultrafnd_git_tpu_torch.parallel import collectives as coll
    from ultrafnd_git_tpu_torch.training.trainer import ForensicTrainer, TrainConfig

    cfg = TrainConfig(**case["cfg"])
    t = ForensicTrainer(cfg, cache=mesh_cache(**case.get("cache", {})), device="cpu")
    if case.get("params"):
        full = torch.load(case["params"], weights_only=True)
        t.state.load_state_dict({**t.state.state_dict(), "params": full})
    val_loss, val = t._epoch_loop(t.va_idx, "val")
    losses, norms, scalars = [], [], t.tx.scalars

    def recorded(grads, count):  # the clip's global norm of each step
        row = scalars(grads, count)
        norms.append(float(row[0]))
        return row

    t.tx.scalars = recorded
    batches = t.epoch_batches(t.tr_idx, True)[: case.get("steps", 0)]
    for chunk, mask, _ in batches:
        loss = t.train_step(chunk, mask)[0].detach().clone()
        if t.mesh is not None:  # this rank's share of the step's loss
            coll.all_reduce_(loss, t._data)
        losses.append(float(loss))
    t.tx.scalars = scalars
    after_loss, after = t._epoch_loop(t.va_idx, "val")
    payload = t.state.state_dict()
    return {
        "val_loss": val_loss, "val": val, "losses": losses, "norms": norms,
        "after_val_loss": after_loss, "after_val": after,
        "params": payload["params"],
        "local": {p: {k: v.clone() for k, v in m.state_dict().items()}
                  for p, m in t.state.params.items()},
        "rows": {k: int(v.shape[0]) for k, v in t.corpus.items()},
        "owned": dict(t._owned),
        "mesh": None if t.mesh is None else {"shape": t.mesh.shape, "coords": t.mesh.coords},
    }


def run_resume_case(case: dict) -> dict:
    """Two epochs unbroken (out_dir `a`) against one epoch, then `--resume`
    to two (out_dir `b`): whether the resumed run's own parameters and
    AdamW moments equal the unbroken run's bit for bit, on this rank."""
    from ultrafnd_git_tpu_torch.training.trainer import ForensicTrainer, TrainConfig

    def fit(out_dir, epochs, resume=False):
        cfg = TrainConfig(**{**case["cfg"], "out_dir": out_dir, "epochs": epochs,
                             "resume": resume})
        t = ForensicTrainer(cfg, cache=mesh_cache(), device="cpu")
        t.fit()
        return t

    a = fit(case["cfg"]["out_dir"] + "/a", 2)
    fit(case["cfg"]["out_dir"] + "/b", 1)
    b = fit(case["cfg"]["out_dir"] + "/b", 2, resume=True)
    same = all(torch.equal(p, dict(b.state.params[part].named_parameters())[n])
               for part, mod in a.state.params.items() for n, p in mod.named_parameters())
    for key in ("mu", "nu"):
        same = same and all(torch.equal(t, b.state.opt_state[key][part][n])
                            for part, d in a.state.opt_state[key].items()
                            for n, t in d.items())
    return {"same": same, "steps": (a.state.step, b.state.step),
            "local_shapes": {n: tuple(p.shape) for n, p in
                             b.state.params["fusion"].named_parameters()}}


def run_error_case(case: dict) -> dict:
    """The error text of a trainer that must refuse `case["cfg"]` (on
    `mesh_cache(**case["cache"])`)."""
    from ultrafnd_git_tpu_torch.training.trainer import ForensicTrainer, TrainConfig

    try:
        ForensicTrainer(TrainConfig(**case["cfg"]), cache=mesh_cache(**case.get("cache", {})),
                        device="cpu")
    except (ValueError, NotImplementedError) as exc:
        return {"error": f"{type(exc).__name__}: {exc}"}
    return {"error": None}


def run_placement_case(case: dict) -> dict:
    """This rank's rows and columns from the placement helpers."""
    from ultrafnd_git_tpu_torch.parallel import mesh as meshlib

    mesh = meshlib.make_mesh(**case["mesh"])
    arr = np.arange(case["rows"], dtype=np.int32)
    chunks = np.arange(3 * case["rows"], dtype=np.int32).reshape(3, -1)
    masks = (chunks % 3 != 0).astype(np.float32)
    ch, ms = meshlib.put_epoch_batches(chunks, masks, mesh)
    return {"coords": mesh.coords, "shape": mesh.shape,
            "rows": meshlib.put_global_batch(arr, mesh), "chunks": ch, "masks": ms}


def run_two_trainers_case(case: dict) -> dict:
    """Two mesh trainers of `case["cfg"]`, one after the other in this
    process, one step each: their losses, whether the second took the
    first one's axis groups, and the default group's backend after each."""
    import torch.distributed as dist

    from ultrafnd_git_tpu_torch.training.trainer import ForensicTrainer, TrainConfig

    out = {"losses": [], "groups": [], "backends": []}
    for _ in range(2):
        t = ForensicTrainer(TrainConfig(**case["cfg"]), cache=mesh_cache(), device="cpu")
        chunk, mask, _ = t.epoch_batches(t.tr_idx, True)[0]
        out["losses"].append(float(t.train_step(chunk, mask)[0]))
        out["groups"].append({"|".join(k): id(v.group) for k, v in t.mesh.shards.items()})
        out["backends"].append(dist.get_backend())
    return out


def run_modules_case(case: dict) -> dict:
    """The tensor-parallel fusion and classifier on this rank's shards: their
    outputs, the gradient of each shard, the global norm over the shards
    and one clipped plain AdamW step (`kernels/adamw.AdamW`) from this
    rank's slices of the unsharded gradients (`inputs["grads"]`: the step
    is then held alone, apart from the backward's rounding)."""
    from ultrafnd_git_tpu_torch.kernels.adamw import AdamW, global_norm
    from ultrafnd_git_tpu_torch.models.classifier import DeepTruthClassifier
    from ultrafnd_git_tpu_torch.models.fusion import CrossModalTransformer
    from ultrafnd_git_tpu_torch.parallel import mesh as meshlib

    data = torch.load(case["inputs"], weights_only=True)
    mesh = meshlib.make_mesh(dp=1, tp=case["tp"])
    tp = mesh.shard(meshlib.MODEL_AXIS)
    mods = {"fusion": CrossModalTransformer(**case["fusion"]),
            "clf": DeepTruthClassifier(**case["clf"])}
    for part, mod in mods.items():
        mod.load_state_dict(data["weights"][part])
    meshlib.shard_modules_(mods, tp)
    fo = mods["fusion"](data["feats"])
    co = mods["clf"](fo["fused"], data["aux"])
    loss = (co["logits"] * data["probe"]).sum() + (fo["logits"] * data["probe"]).sum()
    loss.backward()
    grads = {p: {n: torch.zeros_like(q) if q.grad is None else q.grad.clone()
                 for n, q in m.named_parameters()} for p, m in mods.items()}
    split = [(p, n) for p, d in grads.items() for n in d
             if meshlib.split_dim(p, n) is not None]
    flags = [meshlib.split_dim(p, n) is not None for p, d in grads.items() for n in d]
    norm = global_norm([g for d in grads.values() for g in d.values()], flags, tp)
    opt = AdamW(lambda count: 1e-3, weight_decay=1e-4, grad_clip=case["clip"])
    opt.shard_norm(split, tp)
    state = opt.init(mods)
    given = {p: meshlib.shard_state_dict(p, d, tp) for p, d in data["grads"].items()}
    with torch.no_grad():
        opt.apply(mods, state, given)
    return {"fused": fo["fused"].detach(), "fusion_logits": fo["logits"].detach(),
            "clf_logits": co["logits"].detach(), "probs": co["probs"].detach(),
            "grads": grads, "norm": norm, "coords": mesh.coords,
            "stepped": {p: {k: v.clone() for k, v in m.state_dict().items()}
                        for p, m in mods.items()}}


def run_ring_case(case: dict) -> dict:
    """The ring over an `sp` axis of `case["n"]` ranks (a mesh over the
    world): this rank's output block of `inputs` q, k, v (B, H, S, D) and
    bias (B, 1, 1, S), and the gradients of sum(out * probe) on its q, k
    and v blocks."""
    from ultrafnd_git_tpu_torch.kernels.ring_attention import ring_attention_local
    from ultrafnd_git_tpu_torch.parallel import mesh as meshlib

    data = torch.load(case["inputs"], weights_only=True)
    mesh = meshlib.make_mesh(extra_axes=[("sp", case["n"])])
    sp = mesh.shard("sp")
    per = data["q"].shape[2] // sp.size
    cut = slice(sp.rank * per, (sp.rank + 1) * per)
    q, k, v = (data[n][:, :, cut].clone().requires_grad_() for n in "qkv")
    out = ring_attention_local(q, k, v, data["bias"][..., cut], sp)
    (out * data["probe"][:, :, cut]).sum().backward()
    return {"out": out.detach(), "dq": q.grad, "dk": k.grad, "dv": v.grad,
            "coords": mesh.coords}


def run_tower_case(case: dict) -> dict:
    """The tower of `inputs` ("weights", a TextTransformer state dict; "ids",
    "mask", "probe" of the global batch) on this rank's rows, its `axis`
    ("sp" or "pipe", `case["n"]` ranks) transformed by
    `sequence_parallel_tower_apply` or `pipelined_tower_apply`: the pooled
    rows, the gradients of sum(pooled * probe) summed as the trainer sums
    them, the dropout generator's state after (`case["seed"]` seeds it;
    None is eval mode), the collectives of the forward and of the step and
    the calls of the blocks' bodies in the forward."""
    from ultrafnd_git_tpu_torch.models.dropout import ShardedGenerator
    from ultrafnd_git_tpu_torch.models.transformer import TextTransformer
    from ultrafnd_git_tpu_torch.parallel import collectives as coll
    from ultrafnd_git_tpu_torch.parallel import mesh as meshlib
    from ultrafnd_git_tpu_torch.parallel.pipeline import pipelined_tower_apply
    from ultrafnd_git_tpu_torch.parallel.sequence import sequence_parallel_tower_apply

    data = torch.load(case["inputs"], weights_only=True)
    axis = case["axis"]
    mesh = meshlib.make_mesh(dp=case.get("dp"), extra_axes=[(axis, case["n"])])
    tower = TextTransformer(**case["tower"],
                            dtype=torch.bfloat16 if case.get("bf16") else None)
    tower.load_state_dict(data["weights"])
    block_calls = []
    for blk in tower.blocks:
        def counted(*a, body=blk.body, **kw):
            block_calls.append(1)
            return body(*a, **kw)
        blk.body = counted
    ids, mask, probe = (meshlib.put_global_batch(data[k], mesh) for k in ("ids", "mask", "probe"))
    rows = mesh.shard("data")
    gen = None
    if case.get("seed") is not None:
        gen = ShardedGenerator(torch.Generator().manual_seed(case["seed"]),
                               rows=(rows.rank, rows.size))
    calls = coll.calls
    if axis == "sp":
        out = sequence_parallel_tower_apply(tower, ids, mask, mesh.shard("sp"), gen)
    else:
        out = pipelined_tower_apply(tower, ids, mask, mesh.shard("pipe"),
                                    case.get("microbatches"), rows, gen)
    forward_calls, block_calls = coll.calls - calls, len(block_calls)
    (out.float() * probe).sum().backward()
    grads = {k: torch.zeros_like(p) if p.grad is None else p.grad.clone()
             for k, p in tower.named_parameters()}
    coll.all_reduce_coalesced_([g for k, g in grads.items()
                                if axis == "sp" or not k.startswith("ln_final.")],
                               mesh.shard(axis))
    coll.all_reduce_coalesced_(list(grads.values()), rows)
    return {"out": out.detach().float(), "grads": grads, "coords": mesh.coords,
            "gen_state": None if gen is None else gen.gen.get_state(),
            "calls": (forward_calls, coll.calls - calls), "block_calls": block_calls}


def run_ep_case(case: dict) -> dict:
    """`MoEFFN` of `inputs` ("weights", the whole module's state dict; "x",
    "probe") with its experts cut over an `ep` axis of `case["n"]` ranks:
    the output, the aux loss, this rank's parameter gradients and the
    input's gradient of sum(y * probe) + aux."""
    from ultrafnd_git_tpu_torch.models.moe import MoEFFN, expert_parallel_
    from ultrafnd_git_tpu_torch.parallel import mesh as meshlib

    data = torch.load(case["inputs"], weights_only=True)
    mesh = meshlib.make_mesh(extra_axes=[("ep", case["n"])])
    moe = MoEFFN(**case["moe"])
    moe.load_state_dict(data["weights"])
    expert_parallel_(moe, mesh.shard("ep"))
    x = data["x"].clone().requires_grad_()
    y, aux = moe(x)
    ((y * data["probe"]).sum() + aux).backward()
    return {"y": y.detach(), "aux": aux.detach(), "dx": x.grad, "coords": mesh.coords,
            "grads": {k: p.grad.clone() for k, p in moe.named_parameters()},
            "shapes": {k: tuple(p.shape) for k, p in moe.named_parameters()}}


def run_cli_case(case: dict) -> dict:
    """The training CLI's main() with `case["argv"]` in this rank's process
    (the world's group is the mesh's: no --multihost): its results."""
    from ultrafnd_git_tpu_torch.train import main as train_main

    return {"results": train_main(case["argv"])}


def start(cases: list, world: int, out: Path, nice: int = 10) -> tuple:
    """Start `cases` on `world` gloo ranks (one process each, this script,
    at niceness `nice`); `collect` waits for them."""
    out.mkdir(parents=True, exist_ok=True)
    job = out / "job.json"
    job.write_text(json.dumps({"out": str(out), "cases": cases, "nice": nice}))
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = []
    for r in range(world):
        env = dict(os.environ, PYTHONPATH=str(REPO), JAX_COORDINATOR_ADDRESS=f"localhost:{port}",
                   JAX_NUM_PROCESSES=str(world), JAX_PROCESS_ID=str(r), OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen([sys.executable, __file__, str(job)], env=env, cwd=REPO,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
    return cases, out, procs


def collect(started: tuple, timeout: float = 240) -> list:
    """Each rank's results, {case name: result}, in rank order; raises with
    the log of a rank that failed."""
    cases, out, procs = started
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise RuntimeError(f"rank {r} exited with {p.returncode}:\n{log[-4000:]}")
    return [{c["name"]: torch.load(out / f"{c['name']}.rank{r}.pt", weights_only=False)
             for c in cases} for r in range(len(procs))]


def launch(cases: list, world: int, out: Path, timeout: float = 240) -> list:
    """`start` then `collect`."""
    return collect(start(cases, world, out), timeout)


CASES = {"trainer": run_trainer_case, "error": run_error_case, "resume": run_resume_case,
         "placement": run_placement_case, "modules": run_modules_case,
         "two_trainers": run_two_trainers_case, "ring": run_ring_case,
         "tower": run_tower_case, "ep": run_ep_case, "cli": run_cli_case}


def main(job_path: str) -> None:
    job = json.loads(Path(job_path).read_text())
    # one thread, at a low priority by default: the ranks must not starve
    # the other tests that share the machine
    os.nice(job.get("nice", 10))
    torch.set_num_threads(1)
    from ultrafnd_git_tpu_torch.parallel.mesh import maybe_initialize_distributed

    # a world of one needs no coordinator: make_mesh starts a local group
    if not maybe_initialize_distributed(backend="gloo") and os.environ["JAX_NUM_PROCESSES"] != "1":
        raise SystemExit("no coordinator configured")
    rank = int(os.environ["JAX_PROCESS_ID"])
    out = Path(job["out"])
    for case in job["cases"]:
        result = CASES[case["kind"]](case)
        result["modules"] = sorted(m for m in sys.modules
                                   if m.split(".")[0] in ("jax", "jaxlib", "flax",
                                                          "ultrafnd_git_tpu"))
        torch.save(result, out / f"{case['name']}.rank{rank}.pt")
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1])
