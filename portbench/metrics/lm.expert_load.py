"""lm.expert_load: the busiest expert's rows over the mean expert's, over the
window's expert-layer calls: the growth of the program's sum over calls of
the busiest expert's rows over the growth of its token-expert rows over
the experts (`models/lfm2.moe_counters`, read at the window's start and
end). 1 is an even load. None where the program keeps no such counters."""


def read(rec):
    lm = rec.get("lm") or {}
    start, end = (lm.get("counters") or {}).get("start"), (lm.get("counters") or {}).get("end")
    if not start or not end:
        return None
    rows = end["rows"] - start["rows"]
    busiest = end["busiest_rows"] - start["busiest_rows"]
    return busiest / (rows / lm["experts"]) if rows > 0 else None
