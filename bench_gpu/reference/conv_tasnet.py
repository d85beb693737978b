"""Conv-TasNet, plainly (Luo and Mesgarani, "Conv-TasNet: Surpassing Ideal
Time-Frequency Magnitude Masking for Speech Separation", arXiv:1809.07454;
the layout of desh2608/css ``css/models/conv_tasnet.py``, taken from
JusperLee/Conv-TasNet).

waveform (B, S) -> K + 1 streams, the last (noise) dropped -> (B, K, S):

    w = U x                     frames of L samples at a stride of L/2,
                                N filters and a bias
    e = W_b cLN(w)              LayerNorm over each frame's N channels,
                                then a 1x1 bottleneck to B channels
    R x X blocks, dilation 2^x in block x of each repeat:
        c = gLN(PReLU(W_1 e))                    1x1 to H channels
        c = gLN(PReLU(dwconv_P,2^x(c)))          depthwise, zero "same"
                                                 padding, with a bias
        e = e + W_2 c                            1x1 back to B
    m = ReLU(W_m e)             (K + 1) masks of N channels a frame
    s = V (w * m)               transposed conv: frames of L samples
                                summed in at a stride of L/2, and a bias

gLN normalises over a window's frames and channels jointly: (c - mean) /
sqrt(var + 1e-5) * gamma + beta, the variance biased. cLN and gLN eps
1e-5. A PReLU has one slope.

Where this departs from the paper (as the reference repo's code does,
which the program follows; each read off ``css_tpu_torch/models/
conv_tasnet.py``):

  * a block returns the residual alone, and the mask head reads the last
    block's output: the paper's blocks also give a skip-connection output,
    summed over the blocks, that feeds the mask head;
  * the masks are ReLU's: the paper's are a sigmoid's;
  * the encoder has a bias and no nonlinearity after it;
  * the norm ahead of the bottleneck is cLN, a LayerNorm over each
    frame's channels, in a non-causal model whose blocks use gLN;
  * a noise stream is estimated beside the K speakers and dropped;
  * the encoder and the depthwise kernels are stored as (L, 1, N) and
    (P, 1, H), the decoder's as (L, N, 1): the program's names and
    layouts, so the seeded weights of ``harness/weights.py`` load into
    both. Its ``dense`` initialiser scales by the product of every axis
    but the first (1/sqrt(N) for the encoder, 1/sqrt(H) for a depthwise
    kernel, not the convolutions' fan-in of L and P); the norms that
    follow each of them make the streams independent of that scale but
    for the norms' eps.

Products (the encoder, the 1x1 convolutions, the mask head, the decoder)
go through ``precision.mm``, so ``mode`` rounds their operands; the
depthwise convolution, the norms and the masking are float32.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from bench_gpu.reference.dsp import overlap_add
from bench_gpu.reference.precision import mm

EPS = 1e-5


def blocks(cfg: Dict) -> List[Tuple[str, int]]:
    """(name, dilation) of every block, in order."""
    return [(f"separation_{r}_{x}", 2 ** x)
            for r in range(cfg["num_layers"]) for x in range(cfg["num_blocks"])]


def spec(cfg: Dict) -> List[Tuple[str, tuple, str]]:
    """(name, shape, initialiser) of every tensor, the names those of the
    program's state_dict. The PReLU slopes are drawn ``normal``, so that
    a program which drops a slope, or reads another block's, reads other
    numbers."""
    n, length = cfg["num_filters"], cfg["filter_length"]
    b, h, p = (cfg["bottleneck_channels"], cfg["conv_channels"],
               cfg["kernel_size"])
    s = cfg["num_spk"] + cfg["num_noise"]

    def dense(name, n_in, n_out):
        return [(f"{name}.weight", (n_out, n_in), "dense"),
                (f"{name}.bias", (n_out,), "zeros")]

    def norm(name, dim):
        prefix = name + (".ln" if cfg["norm"] == "cln" else "")
        return [(f"{prefix}.weight", (dim,), "ones"),
                (f"{prefix}.bias", (dim,), "zeros")]

    out = [("encoder_kernel", (length, 1, n), "dense"),
           ("encoder_bias", (n,), "zeros"),
           ("layer_n_s.ln.weight", (n,), "ones"),
           ("layer_n_s.ln.bias", (n,), "zeros")]
    out += dense("bottleneck", n, b)
    for name, _ in blocks(cfg):
        out += dense(f"{name}.conv1x1", b, h)
        out += [(f"{name}.prelu1_a", (1,), "normal")]
        out += norm(f"{name}.norm_1", h)
        out += [(f"{name}.dw_kernel", (p, 1, h), "dense"),
                (f"{name}.dw_bias", (h,), "zeros"),
                (f"{name}.prelu2_a", (1,), "normal")]
        out += norm(f"{name}.norm_2", h)
        out += dense(f"{name}.sc_conv", h, b)
    out += dense("gen_masks", b, s * n)
    out += [("decoder_kernel", (length, n, 1), "dense"),
            ("decoder_bias", (1,), "zeros")]
    return out


def _dense(p, name, x, mode):
    return mm(x, p[f"{name}.weight"].t(), mode) + p[f"{name}.bias"]


def _prelu(x, a):
    return torch.where(x >= 0, x, a * x)


def _norm(p, name, x, kind):
    """x (B, T, C): gLN over (T, C) of each window, or cLN over C."""
    if kind == "cln":
        return F.layer_norm(x, x.shape[-1:], p[f"{name}.ln.weight"],
                            p[f"{name}.ln.bias"], EPS)
    mean = x.mean(dim=(1, 2), keepdim=True)
    var = torch.square(x - mean).mean(dim=(1, 2), keepdim=True)
    return (x - mean) / torch.sqrt(var + EPS) * p[f"{name}.weight"] \
        + p[f"{name}.bias"]


def _depthwise(x, kernel, bias, dilation):
    """x (B, T, C), kernel (P, 1, C): y[t] = bias + sum_k kernel[k] *
    x[t + (k - (P - 1) / 2) * dilation], zero outside the window."""
    taps, t = kernel.shape[0], x.shape[1]
    pad = dilation * (taps - 1) // 2
    xp = F.pad(x, (0, 0, pad, pad))
    y = bias.expand_as(x).clone()
    for k in range(taps):
        y = y + kernel[k, 0] * xp[:, k * dilation: k * dilation + t]
    return y


def streams(p: Dict[str, torch.Tensor], wav: torch.Tensor, cfg: Dict,
            mode: str = "f32") -> torch.Tensor:
    """wav (B, S) float32 -> the speakers' streams (B, K, S') float32, S' =
    (frames - 1) * L / 2 + L."""
    length = cfg["filter_length"]
    stride = length // 2
    n, k = cfg["num_filters"], cfg["num_spk"]
    frames = wav.unfold(-1, length, stride)  # (B, T, L)
    w = mm(frames, p["encoder_kernel"][:, 0], mode) + p["encoder_bias"]
    e = _dense(p, "bottleneck", _norm(p, "layer_n_s", w, "cln"), mode)
    for name, dilation in blocks(cfg):
        c = _prelu(_dense(p, f"{name}.conv1x1", e, mode), p[f"{name}.prelu1_a"])
        c = _norm(p, f"{name}.norm_1", c, cfg["norm"])
        c = _depthwise(c, p[f"{name}.dw_kernel"], p[f"{name}.dw_bias"],
                       dilation)
        c = _norm(p, f"{name}.norm_2", _prelu(c, p[f"{name}.prelu2_a"]),
                  cfg["norm"])
        e = e + _dense(p, f"{name}.sc_conv", c, mode)
    b, t, _ = e.shape
    m = torch.relu(_dense(p, "gen_masks", e, mode)).reshape(b, t, -1, n)
    masked = (w[:, :, None, :] * m[:, :, :k]).transpose(1, 2)  # (B, K, T, N)
    out = mm(masked, p["decoder_kernel"][:, :, 0].t(), mode)  # (B, K, T, L)
    return overlap_add(out, stride) + p["decoder_bias"]
