"""K2, the fused LSTM recurrence of one direction (``csrc/lstm.cu``): xw
(batch, steps, 4h) and W_hh (h, 4h) -> hs (batch, steps, h)."""

from bench_gpu.costs import peaks

NAME = "lstm_kernel"
PROGRAM = ("lstm_cuda", "lstm_fused")


def work(batch: int, steps: int, hidden: int, elem: int = 4):
    """(operations, bytes) of one launch: the recurrent products h W_hh,
    2 * batch * steps * h * 4h; xw and W_hh in, hs out, ``elem`` bytes a
    value."""
    flops = 2.0 * batch * steps * hidden * 4 * hidden
    nbytes = elem * (batch * steps * 4 * hidden + hidden * 4 * hidden
                     + batch * steps * hidden)
    return flops, nbytes


def shape(config: dict, geo: dict):
    """One direction of one layer over a separator batch; None for a model
    without an LSTM of ``hidden_dim`` (split between the directions)."""
    if "hidden_dim" not in config["widths"]:
        return None
    return {"batch": geo["batch"], "steps": geo["frames"],
            "hidden": config["widths"]["hidden_dim"] // 2,
            "elem": geo["elem"]}


def bound_seconds(**shape) -> float:
    """Products on the tensor cores: float32 against TF32's peak (the
    kernel's 3xTF32 does three times the products, so no float32
    implementation can read over its bound), bf16 against bf16's."""
    flops, nbytes = work(**shape)
    peak = peaks.BF16_FLOPS if shape.get("elem", 4) == 2 else peaks.TF32_FLOPS
    return peaks.bound_seconds(flops, nbytes, peak)
