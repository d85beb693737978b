"""BLSTM mask estimator, offline forward (bidirectional, or causal).

Port of ``css_tpu/models/blstm.py``: utterance MVN (running MVN when
causal), linear embedding + LayerNorm + ReLU, N (bi)directional LSTM
layers each followed by a LayerNorm, and a ReLU mask head. Parameter
names follow the Flax modules, so ``params_from_jax`` is a renaming.

Each LSTM direction computes its input projections for all frames as one
product, ``xw = x @ W_ih^T + b`` in the compute dtype (the JAX package's
order: the product, then the bias), and hands the recurrence to
``ops.lstm_cuda.lstm_fused``: the K2 kernel on the card, its plain
version on the CPU. Parameters stay float32; ``compute_dtype`` (bfloat16
when the checkpoint's conf says ``bf16``) is applied where the JAX package
applies it, and LayerNorm normalises in float32 (``conformer.LayerNorm``).
``causal=True`` drops the backward direction and widens the forward LSTM
to the full layer width. Streaming (``stream``, carried (h, c)) waits for
ROADMAP.md Queue 1 item 9; training for item 8.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from css_tpu_torch.models.conformer import Dense, LayerNorm
from css_tpu_torch.ops.features import cumulative_mvn, mvn
from css_tpu_torch.ops import lstm_cuda


def lstm_scan(xw: torch.Tensor, w_hh: torch.Tensor, hidden: int,
              reverse: bool = False, differentiable: bool = False,
              state=None, return_state: bool = False) -> torch.Tensor:
    """The eval-path LSTM over precomputed input projections: xw (B, T, 4h),
    w_hh (h, 4h) -> hs (B, T, h), always through ``lstm_fused``."""
    if differentiable:
        raise NotImplementedError(
            "the differentiable LSTM (training) is not ported yet: ROADMAP.md "
            "Queue 1 item 8")
    if state is not None or return_state:
        raise NotImplementedError(
            "carried LSTM state (streaming) is not ported yet: ROADMAP.md "
            "Queue 1 item 9")
    return lstm_cuda.lstm_fused(xw, w_hh, hidden, reverse=reverse)


class BiLSTMLayer(nn.Module):
    """One (bi)directional LSTM + LayerNorm; dropout is off in eval."""

    def __init__(self, h_dim: int, causal: bool = False):
        super().__init__()
        self.hidden = h_dim if causal else h_dim // 2
        self.dirs = ("fwd",) if causal else ("fwd", "bwd")
        for d in self.dirs:
            self.register_parameter(f"w_ih_{d}", nn.Parameter(
                torch.zeros(4 * self.hidden, h_dim)))
            self.register_parameter(f"w_hh_{d}", nn.Parameter(
                torch.zeros(4 * self.hidden, self.hidden)))
            self.register_parameter(f"b_{d}", nn.Parameter(
                torch.zeros(4 * self.hidden)))
        self.layer_norm = LayerNorm(h_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        outs = []
        for d in self.dirs:
            w_ih = getattr(self, f"w_ih_{d}").to(x.dtype)
            w_hh = getattr(self, f"w_hh_{d}").to(x.dtype)
            xw = x @ w_ih.t() + getattr(self, f"b_{d}").to(x.dtype)
            outs.append(lstm_scan(xw, w_hh.t().contiguous(), self.hidden,
                                  reverse=d == "bwd"))
        x = outs[0] if len(outs) == 1 else torch.cat(outs, dim=-1)
        return self.layer_norm(x)


class BLSTM(nn.Module):
    """BLSTM mask-estimation model: features (B, T, F) -> (y_pred
    (B, num_spk, T, F), masks (B, T, F, num_spk + num_noise))."""

    def __init__(self, idim: int = 257, num_bins: int = 257, num_spk: int = 2,
                 num_noise: int = 1, hidden_dim: int = 1024,
                 num_layers: int = 3,
                 compute_dtype: torch.dtype = torch.float32,
                 causal: bool = False):
        super().__init__()
        self.num_bins = num_bins
        self.num_spk = num_spk
        self.num_noise = num_noise
        self.compute_dtype = compute_dtype
        self.causal = causal
        self.embed_linear = Dense(idim, hidden_dim)
        self.embed_norm = LayerNorm(hidden_dim)
        self.encoders = nn.ModuleList(
            BiLSTMLayer(hidden_dim, causal) for _ in range(num_layers))
        self.linear = Dense(hidden_dim, num_bins * (num_spk + num_noise))

    @classmethod
    def build_model(cls, conf: Dict) -> "BLSTM":
        """From a checkpoint's conf (the css_tpu training flags)."""
        return cls(
            idim=int(conf.get("idim", 257)),
            num_bins=int(conf.get("num_bins", 257)),
            num_spk=int(conf.get("num_spk", 2)),
            num_noise=int(conf.get("num_noise", 1)),
            hidden_dim=int(conf.get("blstm_hdim", 1024)),
            num_layers=int(conf.get("blstm_num_layers", 3)),
            compute_dtype=(torch.bfloat16 if conf.get("bf16")
                           else torch.float32),
            causal=bool(conf.get("blstm_causal", False)),
        )

    def forward(self, f) -> Tuple[torch.Tensor, torch.Tensor]:
        n_src = self.num_spk + self.num_noise
        x = cumulative_mvn(f)[0] if self.causal else mvn(f, dim=-2)
        x = self.embed_linear(x.to(self.compute_dtype))
        x = F.relu(self.embed_norm(x))
        for enc in self.encoders:
            x = enc(x)
        masks = F.relu(self.linear(x)).float()
        b, t, _ = masks.shape
        masks = masks.reshape(b, t, n_src, self.num_bins).transpose(2, 3)
        y_pred = torch.einsum("btfs,btf->bstf", masks[..., : self.num_spk],
                              f[..., : self.num_bins])
        return y_pred, masks


def params_from_jax(params: Dict) -> Dict[str, torch.Tensor]:
    """The JAX package's nested numpy BLSTM params -> a ``BLSTM``
    state_dict: Dense kernels (in, out) become weights (out, in), LayerNorm
    ``scale`` becomes ``weight``, ``encoders_i`` becomes ``encoders.i``; the
    LSTM weights keep their (4h, in) / (4h, h) layout."""
    def tensor(a) -> torch.Tensor:
        return torch.as_tensor(np.array(a, np.float32))

    sd: Dict[str, torch.Tensor] = {}
    for name, p in params.items():
        prefix = name.replace("encoders_", "encoders.")
        for leaf, a in p.items():
            if isinstance(a, dict):  # a layer's layer_norm
                sd[f"{prefix}.{leaf}.weight"] = tensor(a["scale"])
                sd[f"{prefix}.{leaf}.bias"] = tensor(a["bias"])
            elif leaf == "kernel":
                sd[f"{prefix}.weight"] = tensor(np.asarray(a).T)
            elif leaf == "scale":
                sd[f"{prefix}.weight"] = tensor(a)
            else:
                sd[f"{prefix}.{leaf}"] = tensor(a)
    return sd


def _truncated_normal(rng: np.random.Generator, shape, std: float):
    """Normal samples redrawn until they lie within two standard deviations,
    times ``std`` (flax's truncated normal on [-2, 2])."""
    z = rng.standard_normal(shape)
    bad = np.abs(z) > 2.0
    while bad.any():
        z[bad] = rng.standard_normal(int(bad.sum()))
        bad = np.abs(z) > 2.0
    return z * std


def _lecun_normal(rng, shape):
    """flax.linen.initializers.lecun_normal: fan_in is the second-to-last
    axis, truncated normal with the truncation's std correction."""
    return _truncated_normal(rng, shape, np.sqrt(1.0 / shape[-2])
                             / 0.87962566103423978).astype(np.float32)


def _orthogonal(rng, shape):
    """flax.linen.initializers.orthogonal for a 2-D (rows >= cols) shape."""
    q, r = np.linalg.qr(rng.standard_normal(shape))
    return (q * np.sign(np.diag(r))).astype(np.float32)


def init_params(seed: int, conf: Dict) -> Dict:
    """Random BLSTM params from a numpy seed, in the JAX package's layout
    and initialiser families: lecun-normal W_ih and Dense kernels,
    orthogonal W_hh, zero biases, unit LayerNorm scales. Made without JAX
    (for runs where it is absent); load with ``params_from_jax``."""
    with torch.device("meta"):  # the sizes only, nothing allocated
        m = BLSTM.build_model(conf)
    rng = np.random.default_rng(seed)
    hd = m.embed_linear.out_features
    n_out = m.linear.out_features

    def dense(n_in, n_out_):
        return {"kernel": _lecun_normal(rng, (n_in, n_out_)),
                "bias": np.zeros(n_out_, np.float32)}

    def norm(n):
        return {"scale": np.ones(n, np.float32),
                "bias": np.zeros(n, np.float32)}

    params = {"embed_linear": dense(m.embed_linear.in_features, hd),
              "embed_norm": norm(hd)}
    for i, enc in enumerate(m.encoders):
        layer = {}
        for d in enc.dirs:
            layer[f"w_ih_{d}"] = _lecun_normal(rng, (4 * enc.hidden, hd))
            layer[f"w_hh_{d}"] = _orthogonal(rng, (4 * enc.hidden, enc.hidden))
            layer[f"b_{d}"] = np.zeros(4 * enc.hidden, np.float32)
        layer["layer_norm"] = norm(hd)
        params[f"encoders_{i}"] = layer
    params["linear"] = dense(hd, n_out)
    return params
