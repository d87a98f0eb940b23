"""request_p95_ms: the nearest-rank 95th percentile of every request of
the window, call to rows on the host; a failed request is infinitely late."""
from portbench.readers import latencies_ms, percentile


def read(rec):
    lat = latencies_ms(rec)
    return percentile(lat, 95) if lat else None
