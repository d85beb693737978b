"""KN: a Conformer block's residual add and the LayerNorm after it — the
CUDA kernel ``csrc/add_layer_norm.cu`` and its plain version.

Replaces no TPU kernel. On the TPU, XLA fuses each residual add, the casts
and the LayerNorm into their neighbours inside the jitted forward
(``css_tpu/models/conformer.py``, ``EncoderLayer``); on the card each
LayerNorm site of a block ran as four to five PyTorch kernels (the
residual's multiply and add, a copy to float32, PyTorch's LayerNorm on
float32, a copy back to the compute dtype), each a node of the separator's
captured graph. The kernel takes x, an optional y and a scalar alpha, all
(..., C) in float32 or bf16, forms r = x + alpha * y in float32 and rounds
it once to x's dtype (as PyTorch's ``x + alpha * y`` does: bit-equal for
alpha 0.5, whose product is exact), normalises the rounded r over C in
float32 with the LayerNorm's float32 weight, bias and eps, and rounds the
result once. It writes the normalised rows, and r where the caller keeps
it; with no y it is a plain LayerNorm.

What bounds the function on the H100: bytes — at the separator's
(32, 150, 256) bf16, x and y read and r and the normalised rows written
once, 9.8 MB, 2.9 us at 3.35 TB/s (4.9 MB without y and r). See the
source for the design.

Route. ``EncoderLayer.forward`` and ``ConformerEncoder.forward``
(``models/conformer.py``) decide once, before any launch, with
``takes_kernel(norms, x)``: x on CUDA in float32 or bf16, no gradient
recorded, LayerNorms ``norms`` in eval with float32 parameters over x's
last axis, C a multiple of 8 up to ``MAX_CHANNELS``. Then every LayerNorm
of the block (of the embedding) runs as ``add_layer_norm``, through the
registered operator ``css_tpu_torch::add_layer_norm`` (``add_layer_norm_op``,
so ``torch.export`` keeps it as one node and a served artifact launches
it). Everything else takes the composite: the CPU, training and the train
steps, float16; off the CPU it is counted once a block (and once for the
embedding) in ``add_layer_norm.plain_routes``. The hop stream
(``EncoderLayer.stream``) runs the composite and counts nothing.
``add_layer_norm.launches`` counts kernel launches (``ops/_build.py``), a
captured program's replays too (``utils/programs.py``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from css_tpu_torch.ops import _build

DTYPES = (torch.float32, torch.bfloat16)
MAX_CHANNELS = 1024  # a row's values held in a warp's registers
MAX_ROWS = 2 ** 31 - 1  # the row count is a C int
SHAPE_REFUSED = -1  # css_add_layer_norm's return for a plan it does not take


def takes_kernel(norms, x: torch.Tensor) -> bool:
    """Whether the LayerNorms ``norms`` over x's last axis run as the
    kernel (else the composite): decided from x's device, dtype and shape
    and the modules' mode and parameters, before any launch."""
    c = x.shape[-1]
    return (x.device.type == "cuda" and x.dtype in DTYPES
            and not torch.is_grad_enabled()
            and 8 <= c <= MAX_CHANNELS and c % 8 == 0
            and all(not m.training and tuple(m.normalized_shape) == (c,)
                    and m.weight.dtype == torch.float32
                    and m.bias.dtype == torch.float32 for m in norms))


def count_plain(x: torch.Tensor) -> None:
    """Count a composite route of a block's (the embedding's) LayerNorms
    off the CPU."""
    if x.device.type != "cpu":
        _build.KERNELS["add_layer_norm"].plain_routes += 1


@_build.counted
def add_layer_norm(ln, x: torch.Tensor, y: Optional[torch.Tensor] = None,
                   alpha: float = 1.0, keep_sum: bool = False):
    """LayerNorm ``ln`` of r = x + alpha * y (of x when y is None) through
    the operator: the normalised rows, or (r, the normalised rows) with
    ``keep_sum``. The caller has decided the route (``takes_kernel``)."""
    n, r = add_layer_norm_op(x.contiguous(),
                             None if y is None else y.contiguous(), alpha,
                             ln.weight, ln.bias, ln.eps, keep_sum)
    return (r, n) if keep_sum else n


def _check(x: torch.Tensor, y: Optional[torch.Tensor], weight: torch.Tensor,
           bias: torch.Tensor, keep_sum: bool) -> None:
    """The operator's operands as the kernel takes them."""
    if x.dtype not in DTYPES or x.ndim < 1 or not x.is_contiguous():
        raise ValueError(f"add_layer_norm kernel takes a contiguous float32 "
                         f"or bfloat16 x (..., C), got {x.dtype} "
                         f"{tuple(x.shape)}")
    c = x.shape[-1]
    if not (8 <= c <= MAX_CHANNELS and c % 8 == 0
            and x.numel() // c <= MAX_ROWS):
        raise ValueError(f"add_layer_norm kernel: {x.numel() // c} rows of "
                         f"{c} channels; the plan takes C a multiple of 8 up "
                         f"to {MAX_CHANNELS} and up to {MAX_ROWS} rows")
    if y is not None and (y.dtype != x.dtype or y.shape != x.shape
                          or y.device != x.device or not y.is_contiguous()):
        raise ValueError(f"add_layer_norm: y {y.dtype} {tuple(y.shape)} on "
                         f"{y.device}, expected x's contiguous {x.dtype} "
                         f"{tuple(x.shape)} on {x.device}")
    if keep_sum and y is None:
        raise ValueError("add_layer_norm: keep_sum needs y (the sum of x "
                         "alone is x)")
    for name, p in (("weight", weight), ("bias", bias)):
        if (p.dtype != torch.float32 or p.device != x.device
                or not p.is_contiguous() or tuple(p.shape) != (c,)):
            raise ValueError(f"add_layer_norm {name}: {p.dtype} "
                             f"{tuple(p.shape)} on {p.device}, expected "
                             f"contiguous float32 ({c},) on {x.device}")


# The kernel as a registered operator, so that torch.export keeps it as one
# node of the graph: the CPU kernel is the kernel's function in PyTorch
# (the sum rounded once, the LayerNorm in float32, one rounding), the CUDA
# kernel the launch, the fake kernel the shapes for tracing (registered on
# the package's one operator library, ``_build.LIB``). The second output is
# r with ``keep_sum``, else an empty tensor. No autograd formula: a forward
# that records gradients takes the composite.
_build.LIB.define("add_layer_norm(Tensor x, Tensor? y, float alpha, "
                  "Tensor weight, Tensor bias, float eps, bool keep_sum) "
                  "-> (Tensor, Tensor)")


def _add_layer_norm_cpu(x, y, alpha, weight, bias, eps, keep_sum):
    _check(x, y, weight, bias, keep_sum)
    r = x if y is None else (x.float() + alpha * y.float()).to(x.dtype)
    n = F.layer_norm(r.float(), r.shape[-1:], weight, bias, eps).to(x.dtype)
    return n, r if keep_sum else x.new_empty(0)


def _add_layer_norm_cuda(x, y, alpha, weight, bias, eps, keep_sum):
    _check(x, y, weight, bias, keep_sum)
    # the kernel moves every operand 16 bytes at a time
    x, y, weight, bias = (t if t is None or t.data_ptr() % 16 == 0
                          else t.clone() for t in (x, y, weight, bias))
    n = torch.empty_like(x)
    r = torch.empty_like(x) if keep_sum else x.new_empty(0)
    c = x.shape[-1]
    err = _build.load_library().css_add_layer_norm(
        x.data_ptr(), None if y is None else y.data_ptr(),
        r.data_ptr() if keep_sum else None, n.data_ptr(), weight.data_ptr(),
        bias.data_ptr(), x.numel() // c, c, alpha, eps,
        int(x.dtype == torch.bfloat16), x.device.index or 0,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err == SHAPE_REFUSED:
        raise ValueError(f"add_layer_norm kernel refused x {tuple(x.shape)}")
    _build.check(err, "add_layer_norm")
    _build.KERNELS["add_layer_norm"].launches += 1
    return n, r


def _add_layer_norm_fake(x, y, alpha, weight, bias, eps, keep_sum):
    return (torch.empty_like(x),
            torch.empty_like(x) if keep_sum else x.new_empty(0))


_build.LIB.impl("add_layer_norm", _add_layer_norm_cpu, "CPU")
_build.LIB.impl("add_layer_norm", _add_layer_norm_cuda, "CUDA")
torch.library.register_fake("css_tpu_torch::add_layer_norm",
                            _add_layer_norm_fake, lib=_build.LIB)
add_layer_norm_op = torch.ops.css_tpu_torch.add_layer_norm.default
