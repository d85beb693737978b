"""Operand rounding for the reference's matrix products.

``mode`` names the precision a product's operands are rounded to before a
float32 product with float32 accumulation (TF32 switched off, so the
hardware rounds nothing itself):

  * ``f32``: no rounding, the reference;
  * ``bf16``: round to bfloat16 (8 bits of mantissa);
  * ``tf32``: round to TF32's 10 explicit mantissa bits (round to nearest,
    ties away, as the tensor cores' conversion): what float32 with TF32 on
    does to a product, on any device;
  * ``fp8``: e4m3 with one float32 scale a tensor (its absolute maximum
    to 448, the format's largest value): what an fp8 product does.

Under autograd the backward products are rounded alike: both saved
operands as in the forward, and the incoming gradient to ``mode`` (to
e5m2, scaled to 57,344, under ``fp8``, as fp8 training keeps gradients),
so a lower-precision control trains as a port in that precision would.
"""

from __future__ import annotations

import torch

MODES = ("f32", "bf16", "tf32", "fp8")
FP8_MAX = 448.0
E5M2_MAX = 57344.0


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (13 low mantissa bits cleared)."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def _scaled(x: torch.Tensor, dtype, largest: float) -> torch.Tensor:
    scale = torch.clamp(x.abs().amax().float(), min=1e-30) / largest
    return (x / scale).to(dtype).float() * scale


def _rounded(x: torch.Tensor, mode: str) -> torch.Tensor:
    if mode == "f32":
        return x
    if mode == "bf16":
        return x.to(torch.bfloat16).float()
    if mode == "tf32":
        return tf32_round(x.float())
    if mode == "fp8":
        return _scaled(x, torch.float8_e4m3fn, FP8_MAX)
    if mode == "e5m2":
        return _scaled(x, torch.float8_e5m2, E5M2_MAX)
    raise ValueError(f"unknown precision mode {mode!r} (one of {MODES})")


def round_to(x: torch.Tensor, mode: str) -> torch.Tensor:
    """``x`` rounded to ``mode`` (no gradient flows through it)."""
    with torch.no_grad():
        return _rounded(x.detach().float(), mode)


def _sum_to(x: torch.Tensor, shape) -> torch.Tensor:
    """A broadcast operand's gradient summed back to its shape."""
    while x.dim() > len(shape):
        x = x.sum(0)
    for i, n in enumerate(shape):
        if n == 1 and x.shape[i] != 1:
            x = x.sum(i, keepdim=True)
    return x


class _RoundedMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, mode):
        qa, qb = round_to(a, mode), round_to(b, mode)
        ctx.save_for_backward(qa, qb)
        ctx.mode, ctx.shapes = mode, (a.shape, b.shape)
        return qa @ qb

    @staticmethod
    def backward(ctx, grad):
        qa, qb = ctx.saved_tensors
        g = round_to(grad, "e5m2" if ctx.mode == "fp8" else ctx.mode)
        return (_sum_to(g @ qb.transpose(-1, -2), ctx.shapes[0]),
                _sum_to(qa.transpose(-1, -2) @ g, ctx.shapes[1]), None)


def mm(a: torch.Tensor, b: torch.Tensor, mode: str = "f32") -> torch.Tensor:
    """a @ b in float32, every operand of the product and of its backward
    rounded to ``mode``."""
    if mode == "f32":
        return a.float() @ b.float()
    return _RoundedMatmul.apply(a.float(), b.float(), mode)


def strict_float32() -> None:
    """Switch TF32 off for every float32 product and convolution."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
