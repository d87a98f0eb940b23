"""The benchmark of the PyTorch and CUDA port (`ultrafnd_git_tpu_torch`).

`python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>`
runs one cell of `BENCHMARK.json` once and prints one JSON line. Everything
that belongs to one configuration, traffic mix or metric sits in a file of
its own, found by the name `BENCHMARK.json` gives it: `configs/`,
`traffic/`, `workloads/`, `drivers/`, `metrics/`, `rooflines/`, `flops/`.
"""
