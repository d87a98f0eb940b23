"""encode.gemm_share: device time of kernels whose name holds "gemm"
(case-insensitive) over all device time over the traced run's window, in %."""
from portbench.readers import share_of_device


def read(rec):
    return share_of_device(rec, "gemm")
