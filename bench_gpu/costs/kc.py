"""KC, the Conformer's conv module with its block's residual add
(``csrc/conv_module.cu``): x (batch, frames, channels) in float32 or
bf16 -> x + ConvModule(x), the same shape and dtype; LayerNorm, the
scalar GLU, the depthwise conv over ``taps`` frames, BatchNorm, ReLU and
the scalar affine in float32 inside the kernel."""

from bench_gpu.costs import peaks

NAME = "conv_module_kernel"
PROGRAM = ("conv_module_cuda", "conv_module")


def work(batch: int, frames: int, channels: int, taps: int, elem: int = 2):
    """(operations, bytes) of one launch: the taps' multiply-adds,
    2 * batch * frames * channels * taps; x read and the sum written,
    ``elem`` bytes a value, and the float32 parameters (LayerNorm's and
    BatchNorm's 2 + 4 a channel, the taps and their bias, the GLU's 4 and
    the affine's 2 scalars) read once."""
    flops = 2.0 * batch * frames * channels * taps
    params = channels * (2 + taps + 1 + 4) + 4 + 2
    nbytes = 2 * elem * batch * frames * channels + 4 * params
    return flops, nbytes


def shape(config: dict, geo: dict):
    """One block of one separator batch (16 a batch in a 16-block
    Conformer); None for a model without a conv module."""
    widths = config["widths"]
    if "kernel_size" not in widths or "attention_dim" not in widths:
        return None
    return {"batch": geo["batch"], "frames": geo["frames"],
            "channels": widths["attention_dim"],
            "taps": widths["kernel_size"], "elem": geo["elem"]}


def bound_seconds(**shape) -> float:
    """The taps on the CUDA cores' float32 peak (the kernel computes in
    float32 whatever the dtype); bytes at the memory's."""
    flops, nbytes = work(**shape)
    return peaks.bound_seconds(flops, nbytes, peaks.FP32_FLOPS)
