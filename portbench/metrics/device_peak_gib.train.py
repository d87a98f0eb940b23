"""device_peak_gib.train: torch.cuda.max_memory_allocated over the window,
reset at its start, in GiB."""


def read(rec):
    peak = rec["memory"]["window_peak_bytes"]
    return peak / 2 ** 30 if peak else None
