"""Conformer mask estimator, forward only (not causal).

Port of ``css_tpu/models/conformer.py:41-468``: utterance MVN, linear
embedding + LayerNorm + ReLU, N Conformer blocks (Macaron half-FFNs,
relative-position MHSA, scalar-GLU / depthwise-conv / BatchNorm conv
module, post-LN) and a ReLU mask head. Submodule names follow the Flax
modules so ``params_from_jax`` is a mechanical renaming.

Parameters stay float32; ``compute_dtype`` (bfloat16 when the checkpoint's
conf says ``bf16``) is applied where the JAX package applies it:
  * Dense and the depthwise conv cast weight and bias to the input dtype;
  * LayerNorm and BatchNorm normalise in float32 and return the input
    dtype (Flax promotes their statistics to float32);
  * attention scores, their scale and the relative-position term stay in
    the compute dtype, with a cast to float32 only at the softmax input
    and back after it (``conformer.py:91-105``).
The causal/streaming variant waits for ROADMAP.md Queue 1 item 9.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from css_tpu_torch.ops.features import mvn


class Dense(nn.Linear):
    """nn.Linear computing in the input's dtype (Flax Dense with dtype)."""

    def forward(self, x):
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


class LayerNorm(nn.LayerNorm):
    """LayerNorm normalising in float32, returning the input dtype."""

    def __init__(self, dim: int):
        super().__init__(dim, eps=1e-5)

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps).to(x.dtype)


class BatchNorm(nn.Module):
    """Inference BatchNorm over the last axis with running statistics,
    in Flax's order: (x - mean) * (rsqrt(var + eps) * scale) + bias, in
    float32, returning the input dtype."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.register_buffer("running_mean", torch.zeros(dim))
        self.register_buffer("running_var", torch.ones(dim))

    def forward(self, x):
        mul = torch.rsqrt(self.running_var + self.eps) * self.weight
        return ((x.float() - self.running_mean) * mul + self.bias).to(x.dtype)


class FeedForward(nn.Module):
    """Pre-LN FFN: w2(relu(w1(LN(x))))."""

    def __init__(self, d_model: int, d_inner: int):
        super().__init__()
        self.layer_norm = LayerNorm(d_model)
        self.w1 = Dense(d_model, d_inner)
        self.w2 = Dense(d_inner, d_model)

    def forward(self, x):
        return self.w2(F.relu(self.w1(self.layer_norm(x))))


class RelPosMultiHeadAttention(nn.Module):
    """MHSA with a relative-position key term:
    scores = (q k^T + q pos_k^T) / sqrt(d_k)."""

    def __init__(self, n_head: int, n_feat: int):
        super().__init__()
        self.n_head = n_head
        self.n_feat = n_feat
        self.layer_norm = LayerNorm(n_feat)
        self.linear_q = Dense(n_feat, n_feat)
        self.linear_k = Dense(n_feat, n_feat)
        self.linear_v = Dense(n_feat, n_feat)
        self.linear_out = Dense(n_feat, n_feat)

    def _heads(self, x):
        b, t, _ = x.shape
        return x.reshape(b, t, self.n_head, self.n_feat // self.n_head
                         ).transpose(1, 2)

    def forward(self, x, pos_k):
        """x (B, T, n_feat), pos_k (T, T, d_k) or None."""
        x = self.layer_norm(x)
        q = self._heads(self.linear_q(x))
        k = self._heads(self.linear_k(x))
        v = self._heads(self.linear_v(x))
        d_k = self.n_feat // self.n_head
        scores = q @ k.transpose(-1, -2)  # (B, h, T, S)
        if pos_k is not None:
            scores = scores + torch.einsum("bhtd,tsd->bhts", q,
                                           pos_k.to(q.dtype))
        scores = scores / math.sqrt(d_k)
        attn = torch.softmax(scores.float(), dim=-1).to(q.dtype)
        out = attn @ v  # (B, h, T, d)
        b, _, t, _ = q.shape
        return self.linear_out(out.transpose(1, 2).reshape(b, t, self.n_feat))


class ConvModule(nn.Module):
    """Scalar GLU -> depthwise conv over time -> BatchNorm -> ReLU ->
    scalar affine. The reference's "pointwise" convs are Conv2d(1, 2, 1) /
    Conv2d(1, 1, 1) over a singleton channel, i.e. scalar affine maps:
    GLU(x) = (w0 x + b0) * sigmoid(w1 x + b1)."""

    def __init__(self, input_dim: int, kernel_size: int):
        super().__init__()
        self.layer_norm = LayerNorm(input_dim)
        self.pw1_w = nn.Parameter(torch.ones(2))
        self.pw1_b = nn.Parameter(torch.zeros(2))
        self.dw_conv = nn.Conv1d(input_dim, input_dim, kernel_size,
                                 padding=(kernel_size - 1) // 2,
                                 groups=input_dim)
        self.bn = BatchNorm(input_dim)
        self.pw2_w = nn.Parameter(torch.ones(1))
        self.pw2_b = nn.Parameter(torch.zeros(1))

    def forward(self, x):
        dt = x.dtype
        x = self.layer_norm(x)
        w, b = self.pw1_w.to(dt), self.pw1_b.to(dt)
        x = (w[0] * x + b[0]) * torch.sigmoid(w[1] * x + b[1])
        x = F.conv1d(x.transpose(1, 2), self.dw_conv.weight.to(dt),
                     self.dw_conv.bias.to(dt), padding=self.dw_conv.padding,
                     groups=self.dw_conv.groups).transpose(1, 2)
        x = F.relu(self.bn(x))
        return self.pw2_w.to(dt)[0] * x + self.pw2_b.to(dt)[0]


class EncoderLayer(nn.Module):
    """Conformer block with Macaron residuals and post-LN."""

    def __init__(self, d_model: int, n_head: int, d_ffn: int,
                 kernel_size: int):
        super().__init__()
        self.feed_forward_in = FeedForward(d_model, d_ffn)
        self.self_attn = RelPosMultiHeadAttention(n_head, d_model)
        self.conv = ConvModule(d_model, kernel_size)
        self.feed_forward_out = FeedForward(d_model, d_ffn)
        self.layer_norm = LayerNorm(d_model)

    def forward(self, x, pos_k):
        x = x + 0.5 * self.feed_forward_in(x)
        x = x + self.self_attn(x, pos_k)
        x = x + self.conv(x)
        x = x + 0.5 * self.feed_forward_out(x)
        return self.layer_norm(x)


class ConformerEncoder(nn.Module):
    """Embedding + relative positions + N blocks."""

    def __init__(self, idim: int = 257, attention_dim: int = 256,
                 attention_heads: int = 4, linear_units: int = 1024,
                 num_blocks: int = 16, kernel_size: int = 33,
                 relative_pos_emb: bool = True, maxlen: int = 1000):
        super().__init__()
        self.maxlen = maxlen
        self.embed_linear = Dense(idim, attention_dim)
        self.embed_norm = LayerNorm(attention_dim)
        self.pe_k = (nn.Parameter(torch.zeros(
            2 * maxlen, attention_dim // attention_heads))
            if relative_pos_emb else None)
        self.encoders = nn.ModuleList([
            EncoderLayer(attention_dim, attention_heads, linear_units,
                         kernel_size)
            for _ in range(num_blocks)])

    def rel_pos(self, t: int) -> torch.Tensor:
        """pe_k[clip(t - s, -maxlen, maxlen-1) + maxlen] -> (T, T, d_k): a
        plain gather (the one-hot matmul of ``_relpos_band`` is a TPU
        device; both are exact)."""
        pos = torch.arange(t, device=self.pe_k.device)
        rel = torch.clamp(pos[:, None] - pos[None, :], -self.maxlen,
                          self.maxlen - 1) + self.maxlen
        return self.pe_k[rel]

    def forward(self, xs):
        xs = F.relu(self.embed_norm(self.embed_linear(xs)))
        pos_k = self.rel_pos(xs.shape[1]) if self.pe_k is not None else None
        for enc in self.encoders:
            xs = enc(xs, pos_k)
        return xs


class Conformer(nn.Module):
    """Conformer mask-estimation model: features (B, T, F) -> (y_pred
    (B, num_spk, T, F), masks (B, T, F, num_spk + num_noise))."""

    def __init__(self, idim: int = 257, num_bins: int = 257, num_spk: int = 2,
                 num_noise: int = 1, attention_dim: int = 256,
                 attention_heads: int = 4, linear_units: int = 1024,
                 num_blocks: int = 16, kernel_size: int = 33,
                 relative_pos_emb: bool = True,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_bins = num_bins
        self.num_spk = num_spk
        self.num_noise = num_noise
        self.compute_dtype = compute_dtype
        self.conformer = ConformerEncoder(
            idim, attention_dim, attention_heads, linear_units, num_blocks,
            kernel_size, relative_pos_emb)
        self.linear = Dense(attention_dim, num_bins * (num_spk + num_noise))

    @classmethod
    def build_model(cls, conf: Dict) -> "Conformer":
        """From a checkpoint's conf (the css_tpu training flags)."""
        if conf.get("conformer_causal"):
            raise NotImplementedError(
                "the causal Conformer is not ported yet: ROADMAP.md Queue 1 "
                "item 9")
        return cls(
            idim=int(conf.get("idim", 257)),
            num_bins=int(conf.get("num_bins", 257)),
            num_spk=int(conf.get("num_spk", 2)),
            num_noise=int(conf.get("num_noise", 1)),
            attention_dim=int(conf.get("conformer_attention_dim", 256)),
            attention_heads=int(conf.get("conformer_attention_heads", 4)),
            linear_units=int(conf.get("conformer_linear_units", 1024)),
            num_blocks=int(conf.get("conformer_num_blocks", 16)),
            kernel_size=int(conf.get("conformer_kernel_size", 33)),
            relative_pos_emb=bool(conf.get("conformer_relative_pos_emb",
                                           True)),
            compute_dtype=torch.bfloat16 if conf.get("bf16") else torch.float32,
        )

    def forward(self, f) -> Tuple[torch.Tensor, torch.Tensor]:
        n_src = self.num_spk + self.num_noise
        x = self.conformer(mvn(f, dim=-2).to(self.compute_dtype))
        masks = F.relu(self.linear(x)).float()
        b, t, _ = masks.shape
        masks = masks.reshape(b, t, n_src, self.num_bins).transpose(2, 3)
        y_pred = torch.einsum("btfs,btf->bstf", masks[..., : self.num_spk],
                              f[..., : self.num_bins])
        return y_pred, masks


def build_model(conf: Dict) -> Conformer:
    return Conformer.build_model(conf)


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, key + "/"))
        else:
            out[key] = v
    return out


def params_from_jax(params: Dict, batch_stats: Dict = None
                    ) -> Dict[str, torch.Tensor]:
    """The JAX package's nested numpy (params, batch_stats) -> a
    ``Conformer`` state_dict.

    Flax Dense kernels (in, out) are transposed to (out, in); LayerNorm and
    BatchNorm ``scale`` become ``weight``; the depthwise ``dw_kernel``
    (K, 1, C) becomes the conv1d weight (C, 1, K); ``pe_k`` and the scalar
    GLU/affine parameters keep their shape; BatchNorm running mean and
    variance come from ``batch_stats``.
    """
    sd: Dict[str, torch.Tensor] = {}

    def name(path: str) -> str:
        parts = path.split("/")
        out = []
        for p in parts:
            if p.startswith("encoders_"):
                out += ["encoders", p.split("_", 1)[1]]
            else:
                out.append(p)
        return ".".join(out)

    def tensor(a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float32).copy())

    for path, arr in _flatten(params).items():
        key = name(path)
        leaf = key.rsplit(".", 1)[-1]
        a = np.asarray(arr, np.float32)
        if leaf == "kernel" and a.ndim == 2:
            key, a = key[: -len("kernel")] + "weight", a.T
        elif leaf == "dw_kernel":
            key, a = key[: -len("dw_kernel")] + "dw_conv.weight", \
                a.transpose(2, 1, 0)
        elif leaf == "dw_bias":
            key = key[: -len("dw_bias")] + "dw_conv.bias"
        elif leaf == "scale":
            key = key[: -len("scale")] + "weight"
        sd[key] = tensor(a)
    for path, arr in _flatten(batch_stats or {}).items():
        key = name(path)
        stat = {"mean": "running_mean", "var": "running_var"}[
            key.rsplit(".", 1)[-1]]
        sd[key.rsplit(".", 1)[0] + "." + stat] = tensor(arr)
    return sd
