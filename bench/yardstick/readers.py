"""What the per-layer readers share: the port's kernels by name in the
device trace (``csrc/flash_attention.cu``, ``csrc/flash_attention_bwd.cu``)."""
from __future__ import annotations

FLASH_FWD = ("flash_h16_kernel", "flash_f32_kernel", "flash_h16_sliced_kernel",
             "flash_f32_sliced_kernel")
FLASH_BWD_MAIN = ("bwd_h16_kernel", "dkv_f32_kernel")
FLASH_BWD = FLASH_BWD_MAIN + ("stats_kernel", "dq_post_kernel", "dq_f32_kernel")


def kernels(trace, names) -> tuple[float, int]:
    """(seconds, launches) of the traced kernels whose function name is one
    of ``names``."""
    secs, calls = 0.0, 0
    for n, (s, c) in trace.kernels.items():
        if n.rsplit("::", 1)[-1] in names:
            secs += s
            calls += c
    return secs, calls
