"""encode_tokens_per_s: real (unpadded) tokens of the requests finished in
the window over its wall time, host clock."""
from portbench.readers import window_rate


def read(rec):
    return window_rate(rec, "tokens")
