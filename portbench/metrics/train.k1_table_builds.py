"""train.k1_table_builds: K1's pointer-table builds (`adamw.table_builds`,
one each time a leaf's pointer moved and the table was sent again) over
its launches (`adamw.launches`, one an optimizer step), both as the
program counted them since the process started: the set-up's steps (the
GCN warm start's two and the checked steps), the window's, and the traced
run's host-profiled steps after it. None without K1 launches, or where the
program keeps no such counter."""
import sys


def read(rec):
    adamw = sys.modules.get("ultrafnd_git_tpu_torch.kernels.adamw")
    builds = getattr(adamw, "table_builds", None)
    launches = getattr(adamw, "launches", 0)
    if builds is None or not launches:
        return None
    return builds / launches
