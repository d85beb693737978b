"""BLSTM mask estimator, offline (bidirectional, or causal), for inference
and training.

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
to the full layer width; such a model also streams: ``stream_init`` and
``stream`` carry the running-MVN statistics and each layer's (h, c)
across chunks, and chained chunks give the offline forward's masks
(``executor/hop_streaming.py``). The carried c is float32, K2's own
numerics, where ``css_tpu``'s ``stream_init`` makes c in the compute
dtype; in float32 the two are the same.

Training mode (``model.train()``) runs the recurrence as a plain autograd
loop with the JAX package's scan numerics (``lstm_scan(differentiable=
True)``; K2 has no backward, and the JAX package trains through the
scan's VJP, not its Pallas kernel), and adds dropout after the embedding's
LayerNorm and after each layer's LayerNorm (``conformer.Dropout``).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from css_tpu_torch.models.conformer import Dense, Dropout, LayerNorm
from css_tpu_torch.ops.features import cumulative_mvn, mvn
from css_tpu_torch.ops import lstm_cuda


def lstm_scan(xw: torch.Tensor, w_hh: torch.Tensor, hidden: int,
              reverse: bool = False, differentiable: bool = False,
              state=None, return_state: bool = False) -> torch.Tensor:
    """An LSTM over precomputed input projections: xw (B, T, 4h), w_hh
    (h, 4h) -> hs (B, T, h), gate order i, f, g, o. The eval path goes
    through ``lstm_fused`` (K2); ``differentiable=True`` (training) runs
    the JAX package's scan step as a loop that autograd records: gates,
    c and h in xw's dtype (``css_tpu/models/blstm.py:57-76``).

    ``state`` is an initial (h, c), the carry of streaming inference;
    ``return_state=True`` returns (hs, (h, c)) with c in float32. Forward
    only: a reverse scan has no causal carry to chain."""
    if not differentiable:
        return lstm_cuda.lstm_fused(xw, w_hh, hidden, reverse=reverse,
                                    state=state, return_state=return_state)
    if reverse and (state is not None or return_state):
        raise ValueError("lstm_scan: a reverse scan has no causal carry to "
                         "chain (state and return_state are forward only)")
    b, t, _ = xw.shape
    if state is None:
        h, c = xw.new_zeros((b, hidden)), xw.new_zeros((b, hidden))
    else:
        h, c = (v.to(xw.dtype) for v in state)
    hs = [None] * t
    for ti in (range(t - 1, -1, -1) if reverse else range(t)):
        i, f, g, o = (xw[:, ti] + h @ w_hh).chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        hs[ti] = h
    hs = torch.stack(hs, dim=1) if t else xw.new_zeros((b, 0, hidden))
    return (hs, (h, c.float())) if return_state else hs


class BiLSTMLayer(nn.Module):
    """One (bi)directional LSTM + LayerNorm + dropout (off in eval)."""

    def __init__(self, h_dim: int, causal: bool = False,
                 dropout_rate: float = 0.0):
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
        self.dropout = Dropout(dropout_rate)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        outs = []
        for d in self.dirs:
            w_ih = getattr(self, f"w_ih_{d}").to(x.dtype)
            w_hh = getattr(self, f"w_hh_{d}").to(x.dtype)
            xw = x @ w_ih.t() + getattr(self, f"b_{d}").to(x.dtype)
            outs.append(lstm_scan(xw, w_hh.t().contiguous(), self.hidden,
                                  reverse=d == "bwd",
                                  differentiable=self.training))
        x = outs[0] if len(outs) == 1 else torch.cat(outs, dim=-1)
        return self.dropout(self.layer_norm(x))

    def stream(self, x: torch.Tensor, state):
        """A causal layer on one chunk (B, Tc, h_dim) from the carried
        (h, c): -> (LayerNorm'd hs, the new (h, c)). Eval path, no
        dropout."""
        if len(self.dirs) != 1:
            raise ValueError("stream() requires causal=True")
        w_ih = self.w_ih_fwd.to(x.dtype)
        w_hh = self.w_hh_fwd.to(x.dtype)
        xw = x @ w_ih.t() + self.b_fwd.to(x.dtype)
        hs, state = lstm_scan(xw, w_hh.t().contiguous(), self.hidden,
                              state=state, return_state=True)
        return self.layer_norm(hs), state


class BLSTM(nn.Module):
    """BLSTM mask-estimation model: features (B, T, F) -> (y_pred
    (B, num_spk, T, F), masks (B, T, F, num_spk + num_noise))."""

    def __init__(self, idim: int = 257, num_bins: int = 257, num_spk: int = 2,
                 num_noise: int = 1, hidden_dim: int = 1024,
                 num_layers: int = 3,
                 compute_dtype: torch.dtype = torch.float32,
                 causal: bool = False, dropout_rate: float = 0.1):
        super().__init__()
        self.num_bins = num_bins
        self.num_spk = num_spk
        self.num_noise = num_noise
        self.compute_dtype = compute_dtype
        self.causal = causal
        self.embed_linear = Dense(idim, hidden_dim)
        self.embed_norm = LayerNorm(hidden_dim)
        self.embed_dropout = Dropout(dropout_rate)
        self.encoders = nn.ModuleList(
            BiLSTMLayer(hidden_dim, causal, dropout_rate)
            for _ in range(num_layers))
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
            dropout_rate=float(conf.get("blstm_dropout_rate", 0.1)),
        )

    def _mask_head(self, x: torch.Tensor) -> torch.Tensor:
        n_src = self.num_spk + self.num_noise
        masks = F.relu(self.linear(x)).float()
        b, t, _ = masks.shape
        return masks.reshape(b, t, n_src, self.num_bins).transpose(2, 3)

    def forward(self, f) -> Tuple[torch.Tensor, torch.Tensor]:
        x = cumulative_mvn(f)[0] if self.causal else mvn(f, dim=-2)
        x = self.embed_linear(x.to(self.compute_dtype))
        x = F.relu(self.embed_dropout(self.embed_norm(x)))
        for enc in self.encoders:
            x = enc(x)
        masks = self._mask_head(x)
        y_pred = torch.einsum("btfs,btf->bstf", masks[..., : self.num_spk],
                              f[..., : self.num_bins])
        return y_pred, masks

    # ------------------------------------------------------------- streaming
    def stream_init(self, batch: int = 1) -> Dict:
        """The zero carry of ``stream`` on the model's device: the running
        MVN's (count, sum, sumsq) and each layer's (h in the compute dtype,
        c float32)."""
        dev = self.embed_linear.weight.device
        hd = self.embed_linear.out_features
        zeros_f = torch.zeros((batch, self.embed_linear.in_features),
                              device=dev)
        layers = tuple(
            (torch.zeros((batch, hd), dtype=self.compute_dtype, device=dev),
             torch.zeros((batch, hd), device=dev))
            for _ in self.encoders)
        return {"mvn": (torch.zeros((), device=dev), zeros_f, zeros_f),
                "layers": layers}

    @torch.no_grad()
    def stream(self, f: torch.Tensor, carry: Dict):
        """Causal chunk forward: features (B, Tc, F) and the carry ->
        (masks (B, Tc, F, S), the new carry). Chained chunks give the
        offline forward's masks (the same running MVN and recurrence)."""
        if not self.causal:
            raise ValueError("stream() requires a causal=True model")
        x, mvn_carry = cumulative_mvn(f, carry["mvn"])
        x = F.relu(self.embed_norm(self.embed_linear(
            x.to(self.compute_dtype))))
        states = []
        for enc, st in zip(self.encoders, carry["layers"]):
            x, st = enc.stream(x, st)
            states.append(st)
        return self._mask_head(x), {"mvn": mvn_carry,
                                    "layers": tuple(states)}


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
    axis times the receptive field (the leading axes of a conv kernel),
    truncated normal with the truncation's std correction."""
    fan_in = shape[-2] * int(np.prod(shape[:-2]))
    return _truncated_normal(rng, shape, np.sqrt(1.0 / fan_in)
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
