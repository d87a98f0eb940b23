"""Run one cell of BENCHMARK.json once and print its result line.

The cell's name leads to everything else by file: `BENCHMARK.json` gives
its configuration, traffic mix, chips and metrics; `workloads/<cell>.json`
the limits of its comparison, and nothing else; `configs/<config>.json` its sizes; `traffic/<traffic>.json` its
parameters and the driver that runs it (`drivers/<driver>.py`); each metric
is read by `metrics/<metric>.py`. The driver sets up, warms up, drives the
window and runs the comparison; this module checks for the card before and
for JAX after, reads the metrics and prints.
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import math
import os
import re
import sys
from dataclasses import dataclass
from pathlib import Path
from types import SimpleNamespace
from typing import Any, Dict, Iterable, List, Optional, Tuple

from portbench import check
from portbench.peaks import peaks_for

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "ultrafnd_git_tpu")


@dataclass
class Cell:
    name: str
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    limits: Dict[str, float]
    chips: int
    end_to_end: List[Tuple[str, str]]  # (name, unit) of the metrics this cell reports
    per_layer: List[Tuple[str, str]]


def load_json(path: Path) -> Any:
    with open(path, "r", encoding="utf-8") as fh:
        return json.load(fh)


def applies(metric: Dict[str, Any], cell: str, end_to_end: Iterable[str] = ()) -> bool:
    """Whether the cell reports `metric`: the cells its `workloads` names;
    without that key, an end-to-end metric is every cell's and a per-layer
    one is every cell's that reports the end-to-end metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in end_to_end


def load_cell(name: str, spec_path: Path = ROOT / "BENCHMARK.json") -> Cell:
    """The cell `name` of the spec, with its files read. KeyError for a
    cell the spec does not hold, FileNotFoundError for a missing file."""
    spec = load_json(spec_path)
    entry = next((w for w in spec["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in {spec_path.name}")
    limits = load_json(HERE / "workloads" / f"{name}.json")
    e2e = [(m["name"], m["unit"]) for m in spec["end_to_end"] if applies(m, name)]
    return Cell(
        name=name,
        config=load_json(HERE / "configs" / f"{entry['config']}.json"),
        traffic=load_json(HERE / "traffic" / f"{entry['traffic']}.json"),
        limits={k: float(v) for k, v in limits.items()},
        chips=int(entry["chips"]),
        end_to_end=e2e,
        per_layer=[(m["name"], m["unit"]) for m in spec["per_layer"]
                   if applies(m, name, [n for n, _ in e2e])],
    )


def driver(cell: Cell):
    return importlib.import_module(f"portbench.drivers.{cell.traffic['driver']}")


def metric_reader(name: str):
    """`read(rec)` of `metrics/<name>.py`."""
    path = HERE / "metrics" / f"{name}.py"
    mod_name = "portbench_metric_" + re.sub(r"\W", "_", name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    if spec is None or not path.exists():
        raise FileNotFoundError(f"no reader {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules(names: Iterable[str]) -> List[str]:
    """The modules whose top-level name (before the first dot) is, as a
    whole name, one of FORBIDDEN: `ultrafnd_git_tpu_torch` is not."""
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


def set_cache_env() -> None:
    """Keep every build and kernel cache inside the checkout, at fixed
    paths (the port's own nvcc and g++ builds go to build/torch_kernels and
    build/torch_native already), and keep libraries from loading JAX or
    TensorFlow or asking the hub."""
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    for key, value in (("USE_FLAX", "0"), ("USE_TF", "0"), ("USE_JAX", "0"),
                       ("HF_HUB_OFFLINE", "1"), ("TRANSFORMERS_OFFLINE", "1")):
        os.environ[key] = value


def read_metrics(names: List[Tuple[str, str]], rec: Dict[str, Any]) -> Dict[str, Dict[str, Any]]:
    out = {}
    for name, unit in names:
        value = metric_reader(name)(rec)
        if value is not None and math.isfinite(value):
            out[name] = {"value": float(value), "unit": unit}
    return out


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, t0: float,
             device: str = "cuda", control: bool = False) -> Dict[str, Any]:
    """Drive the cell once: {"result": the result line's object, "checks",
    "control" (the control's readings, with `control`)}."""
    import torch

    ctx = SimpleNamespace(cell=cell, cfg=cell.config, traffic=cell.traffic, seed=int(seed),
                          seconds=float(seconds), trace=bool(trace), t0=t0, device=device,
                          control=control)
    out = driver(cell).run(ctx)
    rec = out["rec"]
    on_card = torch.device(device).type == "cuda"
    kind = torch.cuda.get_device_name(0) if on_card else "cpu"
    rec["device_kind"] = kind
    rec["peaks"] = peaks_for(kind)
    checks = check.judge(out["numbers"], cell.limits)
    dev = {"platform": "gpu" if on_card else "cpu", "kind": kind, "count": cell.chips,
           "memory_peak_bytes": int(out["memory_peak_bytes"])}
    result: Dict[str, Any] = {
        "correct": check.passed(checks) and out["failed"] == 0 and out["attempted"] > 0,
        "attempted": int(out["attempted"]),
        "failed": int(out["failed"]),
        "metrics": read_metrics(cell.per_layer if trace else cell.end_to_end, rec),
        "device": dev,
    }
    tr = rec.get("trace")
    if trace and tr is not None:
        dev["busy_s"] = tr["busy_s"]
        dev["window_s"] = tr["window_s"]
        result["breakdown"] = {"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"]}
    result["check"] = checks
    return {"result": result, "checks": checks, "control": out.get("control")}


def emit(result: Dict[str, Any], checks: Dict[str, Dict[str, float]]) -> None:
    sys.stdout.flush()
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


def parse(argv: Optional[List[str]]) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="portbench/run.py", description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv: Optional[List[str]], t0: float) -> int:
    args = parse(argv)
    try:
        cell = load_cell(args.workload)
    except (KeyError, FileNotFoundError) as exc:
        print(f"portbench: {exc}", file=sys.stderr)
        return 2
    set_cache_env()
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"{torch.cuda.device_count()} visible. No result.", file=sys.stderr)
        return 3
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), t0)
    found = forbidden_modules(list(sys.modules))
    if found:
        print(f"portbench: the run loaded {found[:10]}: no result", file=sys.stderr)
        return 4
    emit(out["result"], out["checks"])
    return 0
