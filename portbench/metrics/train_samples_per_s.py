"""train_samples_per_s: real (masked-in) training rows stepped in the
window over its wall time, host clock to the drained device."""
from portbench.readers import window_rate


def read(rec):
    return window_rate(rec, "rows")
