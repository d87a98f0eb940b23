"""encode.pad_share: the padded slots of the encoder's chunks over all of
them (a forward pre-hook counts each chunk's rows x sequence and its mask's
sum), over the requests of the traced run's window, in %."""


def read(rec):
    slots = sum(u.get("slots", 0) for u in rec["units"])
    if not slots:
        return None
    return 100.0 * (1.0 - sum(u["real"] for u in rec["units"]) / slots)
