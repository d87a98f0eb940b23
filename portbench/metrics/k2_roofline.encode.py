"""k2_roofline.encode: K2 (f32) bound at each launch's shape over its device
time over the traced run's window (rooflines/k2.py), in %."""
from portbench.readers import roofline


def read(rec):
    return roofline(rec, "k2", "attn_fwd")
