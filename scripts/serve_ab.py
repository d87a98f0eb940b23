#!/usr/bin/env python3
"""Time the live serving path of two source trees in turns, on one GPU.

    python3 scripts/serve_ab.py --base DIR [--rounds 3]

DIR is another checkout of the repository (for example a `git archive` of
the parent commit unpacked under build/). A seeded full-width model (the
one chip_smoke.py serves before training: tower 768 x 2 x 6 heads, N =
5376 corpus) is written once; then each round runs base, this tree, this
tree, base, each in a fresh process that imports its own tree's package:
Predictor(device="cuda"), a warm-up over the bucket ladder, then the
8-, 64- and 300-record requests of chip_smoke.py seven times each (median
ms, host clock: predict() returns host floats), and the host time of the
300 records' new-node rows alone. Prints one JSON line per process and a
summary line of the medians over rounds.
"""
import argparse
import json
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

WORKER = r"""
import json, statistics, sys, time
root, model = sys.argv[1], sys.argv[2]
sys.path.insert(0, root)
import numpy as np
import chip_smoke as cs  # the tree's own copy (it puts its own root first)
from ultrafnd_git_tpu_torch.serving import Predictor
if cs.REPO.resolve() != __import__("pathlib").Path(root).resolve():
    raise SystemExit(f"imported {cs.REPO}, not {root}")
corpus = cs.synthetic_corpus(cs.N_CORPUS, np.random.default_rng(0))
rng = np.random.default_rng(1)
requests = [cs.synthetic_records(n, corpus, rng) for n in cs.REQUEST_SIZES]
pred = Predictor(model, device="cuda")
pred.warmup(max(cs.REQUEST_SIZES))
out = {}
for recs in requests:
    times = []
    for _ in range(7):
        s = time.perf_counter()
        pred.predict(recs)
        times.append(1e3 * (time.perf_counter() - s))
    out[str(len(recs))] = statistics.median(times)
feats = pred.featurize(requests[-1])
s = time.perf_counter()
for _ in range(5):
    pred._new_node_rows(feats["ocr_sets"][:len(requests[-1])])
out["rows_ms"] = 1e3 * (time.perf_counter() - s) / 5
pred.close()
print("RESULT " + json.dumps(out))
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", required=True, help="the other tree (a checkout)")
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs

    trees = {"base": Path(args.base).resolve(), "this": REPO}
    results = {k: [] for k in trees}
    with tempfile.TemporaryDirectory(prefix="serve_ab_", dir=REPO / "build") as tmp:
        model = str(Path(tmp) / "model")
        cs.build_model_dir(model)
        for _ in range(args.rounds):
            for name in ("base", "this", "this", "base"):
                run = subprocess.run([sys.executable, "-c", WORKER, str(trees[name]), model],
                                     capture_output=True, text=True, timeout=900)
                line = [x for x in run.stdout.splitlines() if x.startswith("RESULT ")]
                if run.returncode != 0 or not line:
                    print(run.stderr[-3000:], file=sys.stderr)
                    return 1
                row = json.loads(line[0][7:])
                results[name].append(row)
                print(json.dumps({"tree": name, **row}), flush=True)
    summary = {name: {k: statistics.median(r[k] for r in rows) for k in rows[0]}
               for name, rows in results.items()}
    print(json.dumps({"median_ms": summary, "processes": {k: len(v) for k, v in results.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
