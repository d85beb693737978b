"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W)."""

BF16_FLOPS = 989e12  # bf16 / fp16 on the tensor cores
TF32_FLOPS = 495e12  # float32 products on the tensor cores
FP32_FLOPS = 67e12  # float32 outside the tensor cores
HBM_BYTES = 3.35e12  # bytes/s

# the peak a model's products are held to, by the configuration's dtype
MODEL_PEAK = {"bfloat16": BF16_FLOPS, "float32": TF32_FLOPS}


def bound_seconds(flops: float, nbytes: float, flops_peak: float) -> float:
    """The least time the card could take: the larger of the operations
    over their peak and the bytes over the memory's."""
    return max(flops / flops_peak, nbytes / HBM_BYTES)
