"""KC: the Conformer's conv module with its block's residual add — the
CUDA kernel ``csrc/conv_module.cu`` and its plain version.

Replaces no TPU kernel. On the TPU, XLA fuses the conv module's chain
(``css_tpu/models/conformer.py``, ``ConvModule``) inside the jitted
forward; on the card the same chain ran as ~25-30 small PyTorch kernels a
block (LayerNorm with its casts, the scalar GLU's broadcast affine ops,
the transposed depthwise conv, BatchNorm's casts and affine ops, ReLU,
the scalar affine, the residual add), each a node of the separator's
captured graph. The kernel computes ``x + ConvModule(x)`` in eval for x
(B, T, C) in float32 or bf16 in one launch, every intermediate in float32
and one rounding at the store (the plain chain in bf16 rounds after
almost every op), reading every parameter in float32 through device
pointers.

What bounds the function on the H100: bytes — x read and the sum written
once, 4.9 MB at the separator's (32, 150, 256) bf16, 1.47 us at 3.35
TB/s; the 33 taps are 80 MFLOP. See the source for the design.

Route. ``conv_module(m, x)``, which ``EncoderLayer.forward`` calls for
``x + m(x)``, launches the kernel through the registered operator
``css_tpu_torch::conv_module`` (``conv_module_op``, so ``torch.export``
keeps it as one node and a served artifact launches it) when
``takes_kernel(m, x)``: x on CUDA in float32 or bf16, ``m`` in eval with
float32 parameters, no gradient recorded, at most ``MAX_CHANNELS``
channels (a multiple of 4) and ``MAX_TAPS`` taps, padding that keeps T
frames. Everything else takes the plain route, ``x + m(x)``: the CPU,
training and the train steps, float16, widths past the plan; off the CPU
it is counted in
``conv_module.plain_routes``, and so is ``ConvModule.stream`` (the hop
path's carried tail, which the kernel does not take). The decision reads
only the input's device, dtype and shape and the module's mode and
parameters. ``conv_module.launches`` counts kernel launches
(``ops/_build.py``), a captured program's replays too
(``utils/programs.py``).
"""

from __future__ import annotations

import operator
from typing import List

import torch
import torch.nn.functional as F

from css_tpu_torch.ops import _build

DTYPES = (torch.float32, torch.bfloat16)
MAX_CHANNELS = 256  # one thread a channel in a block of 256
MAX_TAPS = 33  # taps kept in registers
MAX_ROWS = 65535  # batch rows sit in gridDim.y
SHAPE_REFUSED = -1  # css_conv_module's return for a plan it does not take
# the module's tensors in the operator's order
PARAMS = ("layer_norm.weight", "layer_norm.bias", "pw1_w", "pw1_b",
          "dw_conv.weight", "dw_conv.bias", "bn.running_mean",
          "bn.running_var", "bn.weight", "bn.bias", "pw2_w", "pw2_b")
_params = operator.attrgetter(*PARAMS)


def conv_module_plain(m, x):
    """``ConvModule.forward``: the module's composite of PyTorch ops (no
    residual), in x's dtype."""
    x, k = m._glu(x), m.kernel_size
    if m.causal:  # k - 1 zero frames before the first, none after
        return m._post(m._dw_conv(F.pad(x, (0, 0, k - 1, 0))))
    return m._post(m._dw_conv(x, (k - 1) // 2))


def padding(m):
    """(left, right) zero frames of the GLU output before the taps."""
    k = m.kernel_size
    return (k - 1, 0) if m.causal else ((k - 1) // 2, (k - 1) // 2)


def takes_kernel(m, x: torch.Tensor) -> bool:
    """Whether ``x + m(x)`` runs as the kernel (else the plain route):
    decided from x's device, dtype and shape and m's mode and parameters,
    before any launch."""
    left, right = padding(m)
    return (x.device.type == "cuda" and x.dtype in DTYPES and x.ndim == 3
            and not m.training and not torch.is_grad_enabled()
            and 1 <= x.shape[-1] <= MAX_CHANNELS and x.shape[-1] % 4 == 0
            and 1 <= m.kernel_size <= MAX_TAPS
            and left + right == m.kernel_size - 1
            and all(p.dtype == torch.float32 for p in _params(m)))


def count_plain(x: torch.Tensor) -> None:
    """Count a plain route of the conv module off the CPU."""
    if x.device.type != "cpu":
        _build.KERNELS["conv_module"].plain_routes += 1


@_build.counted
def conv_module(m, x: torch.Tensor) -> torch.Tensor:
    """``x + m(x)`` for a Conformer block's ConvModule ``m`` and its input
    x (B, T, C): the kernel where ``takes_kernel``, else the plain route."""
    if takes_kernel(m, x):
        left, right = padding(m)
        return conv_module_op(x.contiguous(), list(_params(m)), left, right,
                              m.layer_norm.eps, m.bn.eps)
    count_plain(x)
    return x + m(x)


def _check(x: torch.Tensor, params: List[torch.Tensor], left: int,
           right: int) -> int:
    """The operator's operands as the kernel takes them -> the taps K."""
    if x.dtype not in DTYPES or x.ndim != 3 or not x.is_contiguous():
        raise ValueError(f"conv_module kernel takes a contiguous float32 or "
                         f"bfloat16 x (B, T, C), got {x.dtype} "
                         f"{tuple(x.shape)}")
    c = x.shape[2]
    if len(params) != len(PARAMS):
        raise ValueError(f"conv_module: {len(params)} parameters, expected "
                         f"{PARAMS}")
    k = params[4].shape[-1]
    shapes = {"pw1_w": (2,), "pw1_b": (2,), "dw_conv.weight": (c, 1, k),
              "pw2_w": (1,), "pw2_b": (1,)}
    for name, p in zip(PARAMS, params):
        if (p.dtype != torch.float32 or p.device != x.device
                or not p.is_contiguous()
                or tuple(p.shape) != shapes.get(name, (c,))):
            raise ValueError(f"conv_module {name}: {p.dtype} "
                             f"{tuple(p.shape)} on {p.device}, expected "
                             f"contiguous float32 {shapes.get(name, (c,))} "
                             f"on {x.device}")
    if not (c <= MAX_CHANNELS and c % 4 == 0 and k <= MAX_TAPS
            and left >= 0 and right >= 0 and left + right == k - 1):
        raise ValueError(f"conv_module kernel: {c} channels, {k} taps, "
                         f"padding ({left}, {right}): the plan takes at most "
                         f"{MAX_CHANNELS} channels, a multiple of 4, and "
                         f"{MAX_TAPS} taps, padded by k - 1 frames in all")
    return k


# The kernel as a registered operator, so that torch.export keeps it as one
# node of the graph: the CPU kernel is the kernel's function in PyTorch
# (float32 throughout, one rounding), the CUDA kernel the launch, the fake
# kernel the shape for tracing (registered on the package's one operator
# library, ``_build.LIB``). No autograd formula: a forward that records
# gradients takes the plain route.
_build.LIB.define("conv_module(Tensor x, Tensor[] params, int left, "
                  "int right, float ln_eps, float bn_eps) -> Tensor")


def _conv_module_cpu(x, params, left, right, ln_eps, bn_eps):
    """x (B, T, C) and the module's tensors in ``PARAMS`` order -> x +
    ConvModule(x) in x's dtype, the GLU output zero-padded by ``left`` and
    ``right`` frames."""
    _check(x, params, left, right)
    ln_w, ln_b, w1, b1, dw_w, dw_b, mean, var, bn_w, bn_b, w2, b2 = params
    xf = x.float()
    u = F.layer_norm(xf, xf.shape[-1:], ln_w, ln_b, ln_eps)
    g = F.pad((w1[0] * u + b1[0]) * torch.sigmoid(w1[1] * u + b1[1]),
              (0, 0, left, right))
    v = F.conv1d(g.transpose(1, 2), dw_w, dw_b,
                 groups=g.shape[-1]).transpose(1, 2)
    v = F.relu((v - mean) * (torch.rsqrt(var + bn_eps) * bn_w) + bn_b)
    return (xf + (w2[0] * v + b2[0])).to(x.dtype)


def _conv_module_cuda(x, params, left, right, ln_eps, bn_eps):
    k = _check(x, params, left, right)
    if x.data_ptr() % 16:  # the kernel loads x 16 bytes at a time
        x = x.clone()
    b, t, c = x.shape
    out = torch.empty_like(x)
    lib = _build.load_library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    ptrs = [p.data_ptr() for p in params]
    for lo, hi in _build.split_rows(b, MAX_ROWS):
        err = lib.css_conv_module(
            x[lo].data_ptr(), out[lo].data_ptr(), *ptrs, hi - lo, t, c, k,
            left, ln_eps, bn_eps, int(x.dtype == torch.bfloat16),
            x.device.index or 0, stream)
        if err == SHAPE_REFUSED:
            raise ValueError(f"conv_module kernel refused x "
                             f"{tuple(x.shape)}, {k} taps, left {left}")
        _build.check(err, "conv_module")
        _build.KERNELS["conv_module"].launches += 1
    return out


def _conv_module_fake(x, params, left, right, ln_eps, bn_eps):
    return torch.empty_like(x)


_build.LIB.impl("conv_module", _conv_module_cpu, "CPU")
_build.LIB.impl("conv_module", _conv_module_cuda, "CUDA")
torch.library.register_fake("css_tpu_torch::conv_module", _conv_module_fake,
                            lib=_build.LIB)
conv_module_op = torch.ops.css_tpu_torch.conv_module.default
