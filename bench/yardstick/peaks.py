"""Published peaks of one NVIDIA H100 SXM (dense, no sparsity, at the
700 W limit).  A frozen copy of ``repro_torch/core/roofline.py``'s
``HardwareSpec`` defaults (``peak_flops``, ``hbm_bw``) as of the commit
that added this benchmark."""
PEAK_BF16_FLOPS = 989e12      # FLOP/s on the tensor cores, bf16 / f16
HBM_BYTES_PER_S = 3.35e12     # bytes/s of HBM3
