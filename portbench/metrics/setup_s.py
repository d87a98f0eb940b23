"""setup_s: process start to the first timed call (s), compile included."""


def read(rec):
    return rec["setup_s"]
