"""K2: the fused LSTM recurrence — the CUDA kernel ``csrc/lstm.cu`` and its
plain version.

Replaces the TPU kernel ``css_tpu/ops/lstm_pallas.py:lstm_fused`` (body
``_lstm_kernel``): the whole time loop of one LSTM direction over
precomputed input projections xw (B, T, 4h) and the recurrent weights
W_hh (h, 4h), gate order i, f, g, o, ``reverse`` running time backward.
The function ported is the TPU kernel's, which is what the BLSTM's eval
path ran on the TPU: gates and the cell state c in float32, h rounded to
the input dtype every step, the output in the input dtype; bf16 products
summed in float32, float32 products in full float32. (The JAX package's
``lstm_scan`` in bf16, its CPU path, keeps c in bf16 instead.) On the
main path it runs every (layer, direction) of the BLSTM
(``models/blstm.py``): 6 launches per separator batch at full width.

What bounds the function on the H100: operations — at the main shape
(32, 150, 512) float32, the recurrent products are 10.07 GFLOP, 0.150 ms
at the 67 TFLOP/s FP32 peak, against 53 MB of bytes (0.016 ms); the 149
dependent steps add a latency floor that the bound does not count. The
kernel is persistent and cooperative: one launch runs all T steps, each
block keeps its slice of W_hh in shared memory and its cells' c in
registers, and a grid-wide barrier separates the steps; see the source.

``lstm_fused(xw, w_hh, hidden)`` on CPU tensors returns the plain version;
on CUDA tensors it launches the kernel or raises (no fallback, and no
shape gate that routes elsewhere). ``lstm_fused.launches`` counts kernel
launches.
"""

from __future__ import annotations

import torch

from css_tpu_torch.ops import _build

DTYPES = (torch.float32, torch.bfloat16)
SHAPE_REFUSED = -1  # css_lstm's return for a shape the kernel does not take


def lstm_plain(xw: torch.Tensor, w_hh: torch.Tensor, hidden: int,
               reverse: bool = False) -> torch.Tensor:
    """The plain PyTorch version: a loop over time with the TPU kernel's
    numerics. xw (B, T, 4h), w_hh (h, 4h) -> hs (B, T, h) in xw's dtype."""
    b, t, _ = xw.shape
    w = w_hh.float()
    h = xw.new_zeros((b, hidden))
    c = torch.zeros((b, hidden), dtype=torch.float32, device=xw.device)
    out = torch.empty((b, t, hidden), dtype=xw.dtype, device=xw.device)
    for s in range(t):
        ti = t - 1 - s if reverse else s
        gates = xw[:, ti].float() + h.float() @ w
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = (torch.sigmoid(o) * torch.tanh(c)).to(xw.dtype)
        out[:, ti] = h
    return out


def _check(xw: torch.Tensor, w_hh: torch.Tensor, hidden: int) -> None:
    if xw.dtype not in DTYPES or w_hh.dtype != xw.dtype:
        raise TypeError(f"lstm kernel takes float32 or bfloat16 operands of "
                        f"one dtype, got {xw.dtype} and {w_hh.dtype}")
    if (hidden <= 0 or xw.ndim != 3 or xw.shape[2] != 4 * hidden
            or tuple(w_hh.shape) != (hidden, 4 * hidden)):
        raise ValueError(f"lstm kernel takes xw (B, T, 4h) and w_hh (h, 4h) "
                         f"with h = {hidden}, got {tuple(xw.shape)} and "
                         f"{tuple(w_hh.shape)}")
    if not (xw.is_contiguous() and w_hh.is_contiguous()):
        raise ValueError("lstm kernel needs contiguous xw and w_hh")
    if w_hh.device != xw.device:
        raise ValueError(f"lstm kernel: xw on {xw.device}, w_hh on "
                         f"{w_hh.device}")


def lstm_fused(xw: torch.Tensor, w_hh: torch.Tensor, hidden: int,
               reverse: bool = False) -> torch.Tensor:
    """xw (B, T, 4h) input projections plus biases, w_hh (h, 4h) ->
    hs (B, T, h) in xw's dtype (float32 or bfloat16)."""
    if xw.device.type == "cpu":
        return lstm_plain(xw, w_hh, hidden, reverse)
    _check(xw, w_hh, hidden)
    if xw.device.type != "cuda":
        raise ValueError(f"lstm_fused: unsupported device {xw.device}")
    b, t, _ = xw.shape
    out = torch.empty((b, t, hidden), dtype=xw.dtype, device=xw.device)
    lib = _build.load_library()
    err = lib.css_lstm(
        xw.data_ptr(), w_hh.data_ptr(), out.data_ptr(), b, t, hidden,
        int(reverse), int(xw.dtype == torch.bfloat16), xw.device.index or 0,
        torch.cuda.current_stream(xw.device).cuda_stream)
    if err == SHAPE_REFUSED:
        raise ValueError(
            f"lstm kernel: batch {b} with hidden {hidden} does not fit "
            f"(at most 256 product tiles of 4 rows x one unit per block, and "
            f"W_hh's slice in shared memory)")
    _build.check(err, "lstm_fused")
    if b and t:
        lstm_fused.launches += 1
    return out


lstm_fused.launches = 0
