"""The mesh layer: the rank grid, its placement rules and its collectives,
and the two tower transforms on a further mesh axis, `--sp` (ring
attention, `sequence.py`) and `--pp` (GPipe, `pipeline.py`) (counterpart
of `ultrafnd_git_tpu/parallel/`)."""
