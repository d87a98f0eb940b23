"""train.step_ms_p50: the median step of the trainer loop, host clock
between consecutive steps' returns over the traced run's window."""
from portbench.readers import step_period_ms


def read(rec):
    return step_period_ms(rec)
