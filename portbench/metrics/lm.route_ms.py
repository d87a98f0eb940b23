"""lm.route_ms: a request's ms inside the program's `lm.moe.route` spans
(router, top-k, sort, offsets and the row gather), as the device's time of
the operations launched there plus its idle time while the host is there,
over the traced run's window, a request (`encode.request` span). None
where the run recorded no spans."""
from portbench.spans import idle_inside, phase_ms


def read(rec):
    busy = phase_ms(rec, "lm.moe.route", "encode.request")
    if not busy:
        return None
    tr = rec["trace"]
    roots = sum(1 for s in tr["spans"] if s[0] == "encode.request" and s[2] is None)
    return busy + 1e3 * idle_inside(tr["ops"], tr["spans"], "lm.moe.route") / roots
