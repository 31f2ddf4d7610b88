"""The flash-attention forward kernel's share of its roofline in serving:
FLOPs of the pairs between real (unpadded) positions only (4·D a kept
pair a head: what the prompts need), bytes of Q, K and V read once and O
written once at real positions, over the kernel's time in the device
trace, against 989 TFLOP/s and 3.35 TB/s."""
from yardstick import counts, peaks, readers


def read(rec):
    if rec.trace is None or "flash_fwd" not in rec.work:
        return None
    secs, _ = readers.kernels(rec.trace, readers.FLASH_FWD)
    flops, nbytes = rec.work["flash_fwd"]
    return counts.roofline_share(flops, nbytes, secs,
                                 peaks.PEAK_BF16_FLOPS, peaks.HBM_BYTES_PER_S)
