"""Conv-TasNet time-domain separator (port of
``css_tpu/models/conv_tasnet.py``).

A learned conv encoder, channelwise LayerNorm and a 1x1 bottleneck, R
repeats of X dilated depthwise residual blocks (gLN or cLN), a mask head
and a transposed-conv decoder; the trailing noise stream is dropped, so
the model maps (B, N) waveforms to (B, num_spk, N') with N' = (T - 1) *
L/2 + L. Channels-last (B, T, C) throughout, as in the JAX package, and
the parameter names are the JAX package's paths: the encoder, depthwise
and decoder kernels keep their JAX layouts (``encoder_kernel`` (L, 1, N),
``dw_kernel`` (K, 1, C), ``decoder_kernel`` (L, N, 1)), so
``params_from_jax`` (and ``models.to_jax``, back) only transposes Dense
kernels and renames LayerNorm scales. Parameters stay float32; ``compute_dtype`` is applied where the
JAX package applies it. The model has no dropout and no BatchNorm, so
training and eval forwards are the same.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from css_tpu_torch.models.conformer import Dense, LayerNorm

DEFAULT_CONV_TASNET_CONF = {
    "num_filters": 512,
    "filter_length": 16,
    "bottleneck_channels": 128,
    "conv_channels": 512,
    "kernel_size": 3,
    "num_blocks": 8,
    "num_layers": 3,
}


def global_layer_norm(x, scale, bias, eps=1e-5):
    """gLN over (time, channel) jointly, in x's dtype; x: (B, T, C)."""
    mean = torch.mean(x, dim=(1, 2), keepdim=True)
    var = torch.mean(torch.square(x - mean), dim=(1, 2), keepdim=True)
    return scale * (x - mean) / torch.sqrt(var + eps) + bias


class GlobalLayerNorm(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        return global_layer_norm(x, self.weight.to(x.dtype),
                                 self.bias.to(x.dtype))


class ChannelLayerNorm(nn.Module):
    """'cln': LayerNorm over the channels of each frame (Flax's
    ``LayerNorm(name="ln")``)."""

    def __init__(self, dim: int):
        super().__init__()
        self.ln = LayerNorm(dim)

    def forward(self, x):
        return self.ln(x)


NORMS = {"gln": GlobalLayerNorm, "cln": ChannelLayerNorm}


def prelu(x, a):
    return torch.where(x >= 0, x, a.to(x.dtype) * x)


class Conv1DBlock(nn.Module):
    """Dilated depthwise residual block."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 dilation: int, norm: str):
        super().__init__()
        if norm not in NORMS:
            raise ValueError(f"unknown norm {norm!r}")
        self.dilation = dilation
        self.conv1x1 = Dense(in_channels, out_channels)
        self.prelu1_a = nn.Parameter(torch.full((1,), 0.25))
        self.norm_1 = NORMS[norm](out_channels)
        self.dw_kernel = nn.Parameter(torch.zeros(kernel_size, 1,
                                                  out_channels))
        self.dw_bias = nn.Parameter(torch.zeros(out_channels))
        self.prelu2_a = nn.Parameter(torch.full((1,), 0.25))
        self.norm_2 = NORMS[norm](out_channels)
        self.sc_conv = Dense(out_channels, in_channels)

    def forward(self, x):
        c = self.norm_1(prelu(self.conv1x1(x), self.prelu1_a))
        k = self.dw_kernel.shape[0]
        pad = self.dilation * (k - 1) // 2
        c = F.conv1d(c.transpose(1, 2),
                     self.dw_kernel.permute(2, 1, 0).to(c.dtype),
                     self.dw_bias.to(c.dtype), padding=pad,
                     dilation=self.dilation,
                     groups=c.shape[-1]).transpose(1, 2)
        c = self.norm_2(prelu(c, self.prelu2_a))
        return x + self.sc_conv(c)


class ConvTasNet(nn.Module):
    """Waveform (B, N) -> separated waveforms (B, num_spk, N')."""

    # the separator feeds it waveform windows, not K3 features
    domain = "time"

    def __init__(self, num_spk: int = 2, num_noise: int = 1,
                 num_filters: int = 256, filter_length: int = 16,
                 bottleneck_channels: int = 128, conv_channels: int = 256,
                 kernel_size: int = 3, num_blocks: int = 8,
                 num_layers: int = 3, norm: str = "gln",
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_spk = num_spk
        self.n_src = num_spk + num_noise
        self.num_filters = num_filters
        self.filter_length = filter_length
        self.compute_dtype = compute_dtype
        self.encoder_kernel = nn.Parameter(
            torch.zeros(filter_length, 1, num_filters))
        self.encoder_bias = nn.Parameter(torch.zeros(num_filters))
        self.layer_n_s = ChannelLayerNorm(num_filters)
        self.bottleneck = Dense(num_filters, bottleneck_channels)
        self.blocks = []
        for r in range(num_layers):
            for b in range(num_blocks):
                name = f"separation_{r}_{b}"
                self.add_module(name, Conv1DBlock(
                    bottleneck_channels, conv_channels, kernel_size, 2 ** b,
                    norm))
                self.blocks.append(name)
        self.gen_masks = Dense(bottleneck_channels,
                               self.n_src * num_filters)
        self.decoder_kernel = nn.Parameter(
            torch.zeros(filter_length, num_filters, 1))
        self.decoder_bias = nn.Parameter(torch.zeros(1))

    @classmethod
    def build_model(cls, conf: Dict) -> "ConvTasNet":
        """From the css_tpu training flags (``conv_tasnet_*``)."""
        return cls(
            num_spk=int(conf.get("num_spk", 2)),
            num_noise=int(conf.get("num_noise", 1)),
            num_filters=int(conf.get("conv_tasnet_num_filters", 256)),
            filter_length=int(conf.get("conv_tasnet_filter_length", 16)),
            bottleneck_channels=int(
                conf.get("conv_tasnet_bottleneck_channels", 128)),
            conv_channels=int(conf.get("conv_tasnet_conv_channels", 256)),
            kernel_size=int(conf.get("conv_tasnet_kernel_size", 3)),
            num_blocks=int(conf.get("conv_tasnet_num_blocks", 8)),
            num_layers=int(conf.get("conv_tasnet_num_layers", 3)),
            norm=conf.get("conv_tasnet_norm", "gln"),
            compute_dtype=(torch.bfloat16 if conf.get("bf16")
                           else torch.float32),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.ndim == 1:
            x = x[None]
        dt = self.compute_dtype
        stride = self.filter_length // 2
        w = F.conv1d(x[:, None].to(dt),
                     self.encoder_kernel.permute(2, 1, 0).to(dt),
                     self.encoder_bias.to(dt), stride=stride
                     ).transpose(1, 2)  # (B, T, N)
        e = self.bottleneck(self.layer_n_s(w))
        for name in self.blocks:
            e = getattr(self, name)(e)
        b, t, _ = e.shape
        m = F.relu(self.gen_masks(e).reshape(b, t, self.n_src,
                                             self.num_filters))
        d = (w[:, :, None, :] * m).permute(0, 2, 3, 1)  # (B, S, N, T)
        s = F.conv_transpose1d(
            d.reshape(b * self.n_src, self.num_filters, t),
            self.decoder_kernel.permute(1, 2, 0).to(d.dtype),
            self.decoder_bias.to(d.dtype), stride=stride)
        s = s.reshape(b, self.n_src, -1).float()
        return s[:, : self.num_spk]  # the noise stream is dropped


def build_model(conf: Dict) -> ConvTasNet:
    return ConvTasNet.build_model(conf)


def params_from_jax(params: Dict) -> Dict[str, torch.Tensor]:
    """The JAX package's nested numpy ConvTasNet params -> a ``ConvTasNet``
    state_dict: Dense kernels (in, out) become weights (out, in), LayerNorm
    and gLN ``scale`` become ``weight``; the rest keeps name and layout."""
    sd: Dict[str, torch.Tensor] = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}.")
                continue
            a = np.asarray(v, np.float32)
            if k == "kernel":
                k, a = "weight", a.T
            elif k == "scale":
                k = "weight"
            sd[prefix + k] = torch.as_tensor(np.array(a, np.float32))

    walk(params, "")
    return sd


def params_from_torch(state_dict, num_layers: int = 3, num_blocks: int = 8,
                      norm: str = "gln") -> Dict:
    """A reference torch ConvTasNet state_dict -> the JAX package's
    {"params"} numpy layout, leaf for leaf what
    ``css_tpu.models.conv_tasnet.params_from_torch`` gives, for either
    block norm (``gln`` or ``cln``); load it with ``params_from_jax``."""
    def t(name):
        return np.asarray(state_dict[name].detach().cpu().numpy())

    def dense_from_conv1x1(prefix):
        # a 1x1 conv weight (O, I, 1) -> a dense kernel (I, O)
        return {"kernel": t(f"{prefix}.weight")[:, :, 0].T,
                "bias": t(f"{prefix}.bias")}

    def norm_params(prefix, kind):
        if kind == "cln":
            return {"ln": {"scale": t(f"{prefix}.weight"),
                           "bias": t(f"{prefix}.bias")}}
        return {"scale": t(f"{prefix}.weight").reshape(-1),
                "bias": t(f"{prefix}.bias").reshape(-1)}

    params = {
        # encoder conv (N, 1, L) -> (L, 1, N)
        "encoder_kernel": t("encoder.weight").transpose(2, 1, 0),
        "encoder_bias": t("encoder.bias"),
        "layer_n_s": norm_params("LayerN_S", "cln"),
        "bottleneck": dense_from_conv1x1("BottleN_S"),
        "gen_masks": dense_from_conv1x1("gen_masks"),
        # decoder ConvTranspose1d weight (N, 1, L) -> (L, N, 1)
        "decoder_kernel": t("decoder.weight").transpose(2, 0, 1),
        "decoder_bias": t("decoder.bias"),
    }
    for r in range(num_layers):
        for b in range(num_blocks):
            p = f"separation.{r}.{b}"
            params[f"separation_{r}_{b}"] = {
                "conv1x1": dense_from_conv1x1(f"{p}.conv1x1"),
                "prelu1_a": t(f"{p}.PReLU_1.weight"),
                "norm_1": norm_params(f"{p}.norm_1", norm),
                "dw_kernel": t(f"{p}.dwconv.weight").transpose(2, 1, 0),
                "dw_bias": t(f"{p}.dwconv.bias"),
                "prelu2_a": t(f"{p}.PReLU_2.weight"),
                "norm_2": norm_params(f"{p}.norm_2", norm),
                "sc_conv": dense_from_conv1x1(f"{p}.Sc_conv"),
            }
    return {"params": params}
