"""The flash-attention forward kernel's share of its roofline in training:
the larger of its FLOPs (4·D a kept causal pair a head) over 989 TFLOP/s
and its bytes (Q, K and V read once, O written once) over 3.35 TB/s, over
its kernels' time in the device trace.  Every launch of the kernel does a
whole layer's causal attention of the step's batch (the forward and
remat's recompute alike), so the work is a call's times the launches
traced."""
from yardstick import counts, peaks, readers


def read(rec):
    if rec.trace is None or "flash_fwd_call" not in rec.work:
        return None
    secs, calls = readers.kernels(rec.trace, readers.FLASH_FWD)
    flops, nbytes = rec.work["flash_fwd_call"]
    return counts.roofline_share(flops * calls, nbytes * calls, secs,
                                 peaks.PEAK_BF16_FLOPS, peaks.HBM_BYTES_PER_S)
