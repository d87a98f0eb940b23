"""lm.moe_share: device time of the operations launched inside the program's
`lm.moe.route` and `lm.moe.experts` spans (routing, sort, gather, the
expert products and the combine) over all device time of the traced run's
window, in %. None where the run recorded no spans."""
from portbench.spans import attribute, by_name


def read(rec):
    tr = rec.get("trace") or {}
    if not tr.get("spans") or not tr.get("ops") or not tr.get("launches"):
        return None
    per_id = attribute(tr["ops"], tr["launches"], tr["spans"])
    total = sum(per_id.values())
    inside = by_name(per_id, tr["spans"], inclusive=True)
    moe = inside.get("lm.moe.route", 0.0) + inside.get("lm.moe.experts", 0.0)
    return 100.0 * moe / total if total and moe else None
