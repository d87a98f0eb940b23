"""k3k4_roofline.train: the fused f32 backward (K3 + K4) bound at each
launch's shape over its device time, over the traced run's window
(rooflines/k3k4.py), in %."""
from portbench.readers import roofline


def read(rec):
    return roofline(rec, "k3k4", "attn_bwd")
