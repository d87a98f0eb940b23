"""k2bf16_causal_roofline.lm_encode: K2-bf16's causal mode, its bound at
each launch's shape over its device time over the traced run's window
(rooflines/k2_bf16_causal.py), in %."""
from portbench.readers import roofline


def read(rec):
    return roofline(rec, "k2_bf16_causal", "attn_fwd")
