"""Readings that the limits of `correct` are set from, for one cell:

    python3 portbench/calibrate.py --workload <cell> --seconds <s> --seeds <n> [<n> ...]

For each seed, in one process: the cell's set-up, a short window at the
cell's own load and its comparison (the program's readings), and the plain
reference computed again with TF32 on, put in the program's place (the
control's readings: the nearest precision below the configuration's f32).
Prints a JSON line a seed, then the largest program reading and the
smallest control reading of each number. `--fault` plants a fault of
`faults.py` under the timed path: the "program" readings are then the
fault's. Needs the card(s) the cell asks
for; the benchmark's own runs do not run this."""
import time

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path[0] = str(Path(__file__).resolve().parents[1])

import argparse  # noqa: E402
import json  # noqa: E402

from contextlib import nullcontext  # noqa: E402

from portbench import faults, harness  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--fault", choices=sorted(faults.FAULTS), default=None,
                   help="plant this fault under the timed path (faults.py)")
    args = p.parse_args(argv)
    cell = harness.load_cell(args.workload)
    harness.set_cache_env()
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print("calibrate: no card", file=sys.stderr)
        return 3
    prog, ctrl = {}, {}
    for seed in args.seeds:
        with faults.FAULTS[args.fault]() if args.fault else nullcontext():
            out = harness.run_cell(cell, seed, args.seconds, False, time.perf_counter(),
                                   control=True)
        readings = {k: c["value"] for k, c in out["checks"].items()}
        for k, v in readings.items():
            prog.setdefault(k, []).append(v)
        for k, v in out["control"].items():
            ctrl.setdefault(k, []).append(v)
        print(json.dumps({"seed": seed, "program": readings, "control": out["control"],
                          "correct": out["result"]["correct"],
                          "metrics": out["result"]["metrics"]}), flush=True)
        torch.cuda.empty_cache()
    print(json.dumps({"workload": cell.name, "seeds": len(args.seeds),
                      "lower": {k: max(v) for k, v in prog.items()},
                      "upper": {k: min(v) for k, v in ctrl.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
