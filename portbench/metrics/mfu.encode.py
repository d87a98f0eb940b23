"""mfu.encode: model FLOPs (flops/<config>.py) of the window's finished
requests over its wall time, against the configuration's peak (peaks.py), in %."""
from portbench.readers import mfu


def read(rec):
    return mfu(rec)
