"""The rank mesh and its placement rules (counterpart of
`ultrafnd_git_tpu/parallel/mesh.py`).

JAX drives every device of its mesh from one program; torch runs one
process a rank. So the port's mesh of N is N processes in one
`torch.distributed` world, laid out as the grid `([dcn,] data, model,
*extra)` in row-major order (rank = ((dcn_i * dp + data_i) * tp +
model_i) * extra + extra_i), with one process group per axis and one over
the compound data axes `('dcn', 'data')`. The extra axes are JAX's
`extra_axes`: `sp` (`parallel/sequence.py`, the trainer's `--sp`) and
`pipe` (`parallel/pipeline.py`, `--pp`); their ranks hold the same batch
rows:

  * batches split over the data axes: rank r keeps rows
    [i * B / D, (i + 1) * B / D) of a global batch, i its index over
    `data_axes` (dcn-major), D their product (`put_global_batch`; an
    epoch's (steps, B) matrices by columns, `put_epoch_batches`); every
    process computes the same global batch from the same seeded stream;
  * the fusion and classifier MLP pairs split Megatron-style over 'model'
    (`split_dim`: `fuse_mlp.0` / `pre.0` by columns, weight and bias;
    `fuse_mlp.3` / `pre.3` by rows, the bias replicated), everything else
    is replicated;
  * with `--dcn` the gradient sum runs within 'data', then across 'dcn'.

`maybe_initialize_distributed` reads the JAX package's env contract
(JAX_COORDINATOR_ADDRESS, JAX_NUM_PROCESSES, JAX_PROCESS_ID), so the same
launch lines start the port: `init_process_group` over
`tcp://<coordinator>`, NCCL with rank r on `cuda:<local rank>`, or gloo on
the CPU. `make_mesh` takes the default group when one exists and, with no
group and a mesh of one rank, starts a one-rank local group, so a world of
one runs the same code as a world of many.
"""
from __future__ import annotations

import os
import socket
from dataclasses import dataclass
from datetime import timedelta
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ultrafnd_git_tpu_torch.parallel.collectives import Shard, all_reduce_

DATA_AXIS = "data"
MODEL_AXIS = "model"
DCN_AXIS = "dcn"  # the outer data-parallel axis (multi-slice in JAX, multi-node here)
SP_AXIS = "sp"  # the sequence-parallel axis (--sp)
PIPE_AXIS = "pipe"  # the pipeline axis (--pp)

#: exception-text signatures of the known-transient communicator-startup
#: failures (retried by maybe_initialize_distributed)
_TRANSIENT_INIT_SIGNATURES = (
    "Gloo context initialization",
    "DEADLINE_EXCEEDED",
    "Connection reset by peer",
    "Socket Timeout",
)


@dataclass(frozen=True)
class Mesh:
    """This rank's view of the rank grid: axis names and sizes, this rank's
    coordinates, and one `Shard` per axis and per compound axis tuple."""

    axis_names: Tuple[str, ...]
    shape: Dict[str, int]
    rank: int
    coords: Dict[str, int]
    shards: Dict[Tuple[str, ...], Shard]
    backend: str
    device: torch.device

    def shard(self, *axes: str) -> Shard:
        return self.shards[tuple(axes)]


def data_axes(mesh: Mesh) -> Tuple[str, ...]:
    """Mesh axes the batch dimension splits over: ('dcn', 'data') on a mesh
    with a dcn axis, ('data',) otherwise."""
    return (DCN_AXIS, DATA_AXIS) if DCN_AXIS in mesh.axis_names else (DATA_AXIS,)


def data_parallel_size(mesh: Mesh) -> int:
    """Total data-parallel ways (product over `data_axes`)."""
    return int(np.prod([mesh.shape[a] for a in data_axes(mesh)]))


def data_index(mesh: Mesh) -> int:
    """This rank's index over `data_axes`, dcn-major."""
    return mesh.shard(*data_axes(mesh)).rank


def mesh_shape(n_ranks: int, dp: Optional[int] = None, tp: int = 1,
               dcn: int = 1, extra_axes: Sequence[Tuple[str, int]] = ()) -> Dict[str, int]:
    """The ([dcn,] data, model, *extra) sizes of a mesh over `n_ranks`
    ranks, with the JAX package's inference of dp (`make_mesh`: the ranks
    over tp * extra * dcn) and its error."""
    tp, dcn = int(tp), int(dcn)
    extra = [(str(name), int(size)) for name, size in extra_axes]
    extra_total = int(np.prod([size for _, size in extra])) if extra else 1
    if dp is None:
        if n_ranks % (tp * extra_total * dcn) != 0:
            raise ValueError(
                f"{n_ranks} devices not divisible by "
                f"tp*extra*dcn={tp * extra_total * dcn}"
            )
        dp = n_ranks // (tp * extra_total * dcn)
    shape = {DATA_AXIS: int(dp), MODEL_AXIS: tp, **dict(extra)}
    if dcn > 1:
        shape = {DCN_AXIS: dcn, **shape}
    return shape


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def local_rank(rank: int) -> int:
    """The CUDA device index of `rank` on its node: LOCAL_RANK when the
    launcher sets it, else the rank modulo the visible devices."""
    env = os.environ.get("LOCAL_RANK", "")
    if env.isdigit():
        return int(env)
    return rank % max(1, torch.cuda.device_count())


def default_backend(device: Optional[str] = None) -> str:
    """NCCL for a CUDA run, gloo for a CPU one."""
    kind = torch.device(device).type if device else ("cuda" if torch.cuda.is_available()
                                                     else "cpu")
    return "nccl" if kind == "cuda" else "gloo"


def _is_transient_init_error(exc: BaseException) -> bool:
    text = f"{type(exc).__name__}: {exc}"
    return any(sig in text for sig in _TRANSIENT_INIT_SIGNATURES)


def _startup_barrier(backend: str, rank: int) -> None:
    """One all-reduce on the backend's device: builds the communicator while
    every process is still in step."""
    dev = torch.device("cuda", local_rank(rank)) if backend == "nccl" else torch.device("cpu")
    dist.all_reduce(torch.ones(1, device=dev))


def maybe_initialize_distributed(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    timeout_s: Optional[float] = None,
    retries: Optional[int] = None,
    backend: Optional[str] = None,
) -> bool:
    """The `--multihost` hook: `init_process_group` over the coordinator.

    Reads JAX_COORDINATOR_ADDRESS (host:port) / JAX_NUM_PROCESSES /
    JAX_PROCESS_ID when the arguments are omitted. No coordinator, or
    num_processes <= 1, is a no-op returning False. `timeout_s` bounds the
    rendezvous and the collectives (default 300 s, ULTRAFND_DIST_INIT_TIMEOUT_S);
    a known-transient startup failure is retried after a full
    `destroy_process_group` (`retries`, default 1,
    ULTRAFND_DIST_INIT_RETRIES); a terminal one raises RuntimeError naming
    the coordinator, this process and the knobs. `backend` defaults to NCCL
    when CUDA is visible, else gloo; under NCCL the process takes
    `cuda:<local rank>` first.
    """
    coord = coordinator or os.environ.get("JAX_COORDINATOR_ADDRESS")
    n_str = os.environ.get("JAX_NUM_PROCESSES", "")
    n = num_processes if num_processes is not None else (int(n_str) if n_str.isdigit() else 0)
    pid_str = os.environ.get("JAX_PROCESS_ID", "")
    pid = process_id if process_id is not None else (
        int(pid_str) if pid_str.isdigit() else None)
    if not coord or n <= 1 or pid is None:
        return False
    if timeout_s is None:
        timeout_s = float(os.environ.get("ULTRAFND_DIST_INIT_TIMEOUT_S", "300"))
    if retries is None:
        retries = int(os.environ.get("ULTRAFND_DIST_INIT_RETRIES", "1"))
    backend = backend or default_backend()

    diagnostic = (
        f"(coordinator={coord}, process {pid} of {n}; "
        f"timeout_s={timeout_s:g} via ULTRAFND_DIST_INIT_TIMEOUT_S, "
        f"retries via ULTRAFND_DIST_INIT_RETRIES). Check that every "
        f"process can reach the coordinator address, that all {n} "
        f"processes launched with distinct JAX_PROCESS_ID in [0, {n}), "
        f"and that process 0's port is free."
    )
    if backend == "nccl":
        torch.cuda.set_device(local_rank(pid))
    attempt = 0
    while True:
        try:
            dist.init_process_group(
                backend, init_method=f"tcp://{coord}", world_size=n, rank=pid,
                timeout=timedelta(seconds=max(1.0, float(timeout_s))))
            _startup_barrier(backend, pid)
            return True
        except Exception as exc:  # noqa: BLE001 — transport errors vary
            transient = _is_transient_init_error(exc)
            try:
                dist.destroy_process_group()
            except Exception:  # noqa: BLE001 — best-effort cleanup
                pass
            if transient and attempt < retries:
                attempt += 1
                print("multi-host init: transient communicator-startup "
                      f"failure ({type(exc).__name__}), retry "
                      f"{attempt}/{retries} {diagnostic}", flush=True)
                continue
            kind = "transient" if transient else "terminal"
            raise RuntimeError(
                f"multi-host initialization failed ({kind}: "
                f"{type(exc).__name__}: {exc}) {diagnostic}"
            ) from exc


#: the default group when make_mesh started it; the axis groups made in
#: the default group `_groups_world`, by their ranks (a later mesh in the
#: process takes them again: repeated trainers make no new groups)
_local_world = None
_groups_world = None
_groups: Dict[Tuple[int, ...], object] = {}


def _group(ranks) -> object:
    """The process group over `ranks` in the current default group."""
    global _groups_world
    if _groups_world is not dist.group.WORLD:
        _groups.clear()
        _groups_world = dist.group.WORLD
    key = tuple(int(r) for r in ranks)
    if key not in _groups:
        _groups[key] = dist.new_group(list(key))
    return _groups[key]


def _start_local_group(backend: str) -> None:
    """A one-rank group on this process (the coordinator's address when one
    is set, else a free local port)."""
    addr = os.environ.get("JAX_COORDINATOR_ADDRESS") or f"localhost:{_free_port()}"
    if backend == "nccl":
        torch.cuda.set_device(local_rank(0))
    dist.init_process_group(backend, init_method=f"tcp://{addr}", world_size=1, rank=0)


def make_mesh(dp: Optional[int] = None, tp: int = 1, dcn: int = 1,
              device: Optional[torch.device] = None, backend: Optional[str] = None,
              extra_axes: Sequence[Tuple[str, int]] = ()) -> Mesh:
    """The ([dcn,] data, model, *extra) mesh over the default process
    group, this rank's coordinates and its axis groups (`extra_axes`:
    (name, size) pairs, JAX's; the trainer's ("sp", n) or ("pipe", n)).

    dp defaults to the world over tp * extra * dcn (JAX's inference over
    devices).
    With no default group, a mesh of one rank starts a one-rank local group
    (`backend`, default NCCL for a CUDA `device`, gloo for the CPU); a
    larger mesh raises, as does a world that does not equal the mesh. Every
    rank must call this, in the same order as its other group creations.
    `device` is the rank's device (cuda:<local rank> by default when CUDA is
    visible to an NCCL group, the CPU under gloo without a device; a CUDA
    device without an index is cuda:<local rank>). `shard(*axis_names)` is
    the whole world. A local group that an earlier mesh started with
    another backend is started anew; a caller's NCCL group refuses a CPU
    mesh."""
    global _local_world
    want = backend or default_backend(str(device) if device else None)
    if dist.is_initialized() and dist.group.WORLD is _local_world \
            and dist.get_backend() != want:
        dist.destroy_process_group()
    started = dist.is_initialized()
    world = dist.get_world_size() if started else None
    shape = mesh_shape(world if world is not None else 1, dp, tp, dcn, extra_axes)
    n = int(np.prod(list(shape.values())))
    if not started:
        if n != 1:
            raise ValueError(
                f"the mesh {shape} has {n} ranks but no process group is initialised: "
                f"launch {n} processes with --multihost (JAX_COORDINATOR_ADDRESS, "
                "JAX_NUM_PROCESSES, JAX_PROCESS_ID) or initialise torch.distributed first")
        _start_local_group(want)
        _local_world = dist.group.WORLD
        world = 1
    elif dist.get_backend() == "nccl" and device is not None \
            and torch.device(device).type == "cpu":
        raise ValueError("the process group's backend is NCCL, which cannot reduce the "
                         "tensors of a mesh on the CPU: initialise a gloo group")
    if world != n:
        raise ValueError(f"the mesh {shape} has {n} ranks but the process group's world "
                         f"has {world}")
    rank = dist.get_rank()
    names = tuple(shape)
    sizes = [shape[a] for a in names]
    coords = dict(zip(names, np.unravel_index(rank, sizes)))
    coords = {a: int(i) for a, i in coords.items()}
    grid = np.arange(n).reshape(sizes)
    shards: Dict[Tuple[str, ...], Shard] = {}
    extra = [str(name) for name, _ in extra_axes]
    # names: the whole world; the extra axes' groups come after the others
    axis_sets = [(a,) for a in names if a not in extra] + [names]
    if DCN_AXIS in names:
        axis_sets.append((DCN_AXIS, DATA_AXIS))
    axis_sets += [(a,) for a in extra]
    for axes in axis_sets:
        moved = np.moveaxis(grid, [names.index(a) for a in axes],
                            list(range(len(names) - len(axes), len(names))))
        lines = moved.reshape(-1, int(np.prod([shape[a] for a in axes])))
        for line in lines:  # every rank creates every group, in one order
            group = _group(line)
            if rank in line:
                shards[axes] = Shard(group, int(np.flatnonzero(line == rank)[0]), len(line))
    backend_name = dist.get_backend()
    device = torch.device(device if device is not None else
                          ("cuda" if backend_name == "nccl" else "cpu"))
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", local_rank(rank))
    return Mesh(names, shape, rank, coords, shards, backend_name, device)


# ---- placement: this rank's rows ------------------------------------------
def _local_rows(arr, index: int, parts: int):
    """Rows [index * n / parts, (index + 1) * n / parts) of `arr` (numpy or
    torch); ValueError when they do not divide evenly."""
    if arr.shape[0] % parts:
        raise ValueError(
            f"global batch rows ({arr.shape[0]}) must divide evenly over "
            f"{parts} data-parallel ranks — pad with mesh.pad_to_multiple first"
        )
    per = arr.shape[0] // parts
    return arr[index * per: (index + 1) * per]


def put_global_batch(arr, mesh: Mesh):
    """This rank's rows of a global batch (every process holds the same
    global batch): the rows JAX's `put_global_batch` places on the device
    of this rank's mesh coordinates."""
    return _local_rows(arr, data_index(mesh), data_parallel_size(mesh))


def put_epoch_batches(chunks, masks, mesh: Mesh):
    """This rank's batch columns of an epoch's (steps, B) index and mask
    matrices (the scan axis stays whole)."""
    parts, i = data_parallel_size(mesh), data_index(mesh)
    if chunks.shape[1] % parts:
        raise ValueError(f"batch axis ({chunks.shape[1]}) must divide evenly over "
                         f"{parts} data-parallel ranks")
    per = chunks.shape[1] // parts
    return chunks[:, i * per: (i + 1) * per], masks[:, i * per: (i + 1) * per]


def owned_rows(n_rows: int, mesh: Mesh) -> Optional[slice]:
    """The rows of an (n_rows, ...) corpus array this rank holds when the
    array is row-split over the data axes (`--shard_corpus`,
    `--shard_graph`), or None when n_rows does not divide (the array is
    then replicated, as the JAX trainer's `_put_row_sharded`)."""
    parts = data_parallel_size(mesh)
    if n_rows % parts:
        return None
    per = n_rows // parts
    return slice(data_index(mesh) * per, (data_index(mesh) + 1) * per)


def pad_to_multiple(idx: np.ndarray, multiple: int) -> np.ndarray:
    """Pad a 1-D index array by repeating the last element."""
    r = len(idx) % multiple
    if r == 0:
        return idx
    pad = np.full(multiple - r, idx[-1] if len(idx) else 0, idx.dtype)
    return np.concatenate([idx, pad])


# ---- the Megatron split of the parameters -----------------------------------
_COLUMN = {("fusion", "fuse_mlp.0"), ("clf", "pre.0")}
_ROW = {("fusion", "fuse_mlp.3"), ("clf", "pre.3")}


def split_dim(part: str, name: str) -> Optional[int]:
    """The dim of parameter `name` of module `part` ("fusion", "clf", ...)
    split over 'model', or None when it is replicated. A torch weight is
    (out, in): a column-parallel layer (the JAX kernel's out axis) splits
    dim 0 of its weight and its bias, a row-parallel one dim 1 of its
    weight, its bias replicated (JAX `_spec_for_path`)."""
    layer, _, kind = name.rpartition(".")
    if (part, layer) in _COLUMN:
        return 0
    if (part, layer) in _ROW and kind == "weight":
        return 1
    return None


def shard_slice(t: torch.Tensor, dim: int, tp: Shard) -> torch.Tensor:
    """This rank's 1/tp of `t` along `dim`."""
    if t.shape[dim] % tp.size:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split over tp={tp.size}")
    per = t.shape[dim] // tp.size
    return t.narrow(dim, tp.rank * per, per)


def shard_state_dict(part: str, sd: Dict[str, torch.Tensor], tp: Optional[Shard]):
    """A full state dict of module `part`, cut to this rank's shards."""
    if tp is None:
        return sd
    out = {}
    for name, t in sd.items():
        dim = split_dim(part, name)
        out[name] = t if dim is None else shard_slice(t, dim, tp).contiguous()
    return out


def gather_shard(t: torch.Tensor, dim: int, tp: Shard) -> torch.Tensor:
    """The full tensor of which every rank of `tp` holds its slice `t`
    along `dim` (owner fills, all-reduce sums: exact)."""
    shape = list(t.shape)
    shape[dim] *= tp.size
    full = t.new_zeros(shape)
    full.narrow(dim, tp.rank * t.shape[dim], t.shape[dim]).copy_(t)
    return all_reduce_(full, tp)


def gather_state_dict(part: str, sd: Dict[str, torch.Tensor], tp: Optional[Shard]):
    """The full state dict of module `part` from this rank's shards (every
    rank of `tp` must call it)."""
    if tp is None:
        return sd
    return {name: (t if split_dim(part, name) is None
                   else gather_shard(t, split_dim(part, name), tp))
            for name, t in sd.items()}


def shard_modules_(params: Dict[str, torch.nn.Module], tp: Shard) -> None:
    """Cut the split parameters of `params` ({part: module}) to this rank's
    shards in place, and hand the fusion and classifier their model-axis
    shard (their forward then runs the Megatron pair)."""
    for part, mod in params.items():
        for name, p in list(mod.named_parameters()):
            dim = split_dim(part, name)
            if dim is None:
                continue
            owner = mod.get_submodule(name.rpartition(".")[0])
            setattr(owner, name.rpartition(".")[2],
                    torch.nn.Parameter(shard_slice(p.data, dim, tp).clone()))
        if part in ("fusion", "clf"):
            mod.tp = tp

