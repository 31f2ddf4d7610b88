"""The attention backward's share of its roofline: 8·D a kept pair a head
(dV, dP, dQ, dK; recomputing S is not counted, so a backward that keeps P
cannot read over 100 %), bytes of Q, K, V, O, dO and the row statistics
read once and dQ, dK, dV written once, over the time of its pre-pass, main
kernel and post-pass in the device trace.  One main-kernel launch is one
layer's backward."""
from yardstick import counts, peaks, readers


def read(rec):
    if rec.trace is None or "flash_bwd_call" not in rec.work:
        return None
    secs, _ = readers.kernels(rec.trace, readers.FLASH_BWD)
    _, calls = readers.kernels(rec.trace, readers.FLASH_BWD_MAIN)
    flops, nbytes = rec.work["flash_bwd_call"]
    return counts.roofline_share(flops * calls, nbytes * calls, secs,
                                 peaks.PEAK_BF16_FLOPS, peaks.HBM_BYTES_PER_S)
