"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, no
sparsity, at its 700 W limit). The split-TF32 route's own ceiling
(``ops/cuda/mma_peak.py``, 319.65 TFLOP/s measured) is one implementation's
and is not a peak here."""
TF32_FLOPS = 495e12   # the fastest fp32-grade rate on the chip
BF16_FLOPS = 989e12
FP32_SIMT_FLOPS = 67e12
HBM_BYTES = 3.35e12


def least_seconds(ops: float, nbytes: float, flops: float = TF32_FLOPS) -> float:
    """The least time the chip could take: the larger of the two bounds."""
    return max(ops / flops, nbytes / HBM_BYTES)
