"""device_idle.train: 1 - the union of device operation intervals over the
window's wall time in the traced run (CUDA activity alone
recorded), in %."""
from portbench.readers import idle_share


def read(rec):
    return idle_share(rec)
