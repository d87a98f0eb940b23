"""The mesh layer: the rank grid, its placement rules and its collectives
(counterpart of `ultrafnd_git_tpu/parallel/`; `--sp` and `--pp` are not
ported)."""
