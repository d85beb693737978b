"""Conformer mask estimator, offline or causal, for inference, streaming
and training.

Port of ``css_tpu/models/conformer.py:41-500``: utterance MVN, linear
embedding + LayerNorm + ReLU, N Conformer blocks (Macaron half-FFNs,
relative-position MHSA, scalar-GLU / depthwise-conv / BatchNorm conv
module, post-LN) and a ReLU mask head. Submodule names follow the Flax
modules so ``params_from_jax`` (and ``models.to_jax``, back) are
mechanical renamings.

Training mode (``model.train()``) follows the Flax model's ``train=True``:
dropout at the JAX package's sites (after the embedding's LayerNorm, in
each FFN after the ReLU and after the second Dense, on the attention
probabilities and after ``linear_out``, at the end of the conv module),
drawn from the ``torch.Generator`` that ``set_dropout_generator`` hands
every ``Dropout``; and BatchNorm on the batch's statistics with Flax's
running update (see ``BatchNorm``). ``model.eval()`` gives the inference
forward.

Parameters stay float32; ``compute_dtype`` (bfloat16 when the checkpoint's
conf says ``bf16``) is applied where the JAX package applies it:
  * Dense and the depthwise conv cast weight and bias to the input dtype;
  * LayerNorm and BatchNorm normalise in float32 and return the input
    dtype (Flax promotes their statistics to float32);
  * attention scores, their scale and the relative-position term stay in
    the compute dtype, with a cast to float32 only at the softmax input
    and back after it (``conformer.py:91-105``).

``causal=True`` (``conformer_causal`` in a checkpoint's conf) is the
streamable variant: running MVN (``cumulative_mvn``), attention banded to
``0 <= t - s < left_context`` (masked scores set to -1e9 in the compute
dtype before the float32 softmax) and a depthwise conv padded on the left
only. Causality changes no parameter, so any Conformer checkpoint loads
into it. ``stream_init`` / ``stream`` carry the running-MVN statistics and
each block's rolled KV cache of ``left_context`` frames (with flags for
the slots filled so far) and conv tail of ``kernel_size - 1`` frames:
chained chunks give the causal offline forward's masks.

Parallel training (``parallel/dp.py``): ``set_batchnorm_group`` makes
every BatchNorm take its training statistics over the global batch of a
data group, and ``tp_group=`` builds the tensor-parallel shard of the
model, the JAX package's ``conformer_tp_spec`` layout: w1 and Q/K/V split
on their outputs (the attention by heads), w2 and linear_out on their
inputs, each followed by a sum over the group and then its bias. A model
built with neither behaves exactly as one built before them.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from css_tpu_torch.ops.features import cumulative_mvn, mvn
from css_tpu_torch.parallel.mesh import (all_reduce_sum, copy_to,
                                         group_size, reduce_from)


class Dense(nn.Linear):
    """nn.Linear computing in the input's dtype (Flax Dense with dtype)."""

    def forward(self, x):
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


class RowParallelDense(Dense):
    """Dense whose input dimension is split over ``group``: the partial
    products are summed over the group, then the bias is added once."""

    def __init__(self, in_features: int, out_features: int, group=None):
        super().__init__(in_features, out_features)
        self.group = group

    def forward(self, x):
        if self.group is None:
            return super().forward(x)
        y = reduce_from(F.linear(x, self.weight.to(x.dtype)), self.group)
        return y + self.bias.to(x.dtype)


class LayerNorm(nn.LayerNorm):
    """LayerNorm normalising in float32, returning the input dtype."""

    def __init__(self, dim: int):
        super().__init__(dim, eps=1e-5)

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps).to(x.dtype)


class BatchNorm(nn.Module):
    """BatchNorm over the last axis in Flax's order: (x - mean) *
    (rsqrt(var + eps) * scale) + bias, in float32, returning the input
    dtype.

    Eval: the running statistics. Training (Flax ``nn.BatchNorm(momentum=
    0.9)`` with ``use_running_average=False``): the batch's mean and its
    biased variance over every axis but the last, E[x^2] - E[x]^2 clipped
    at 0 (Flax's fast variance), and the running statistics move as
    ``ra = 0.9 ra + 0.1 batch``, the variance biased too. This is not
    ``torch.nn.BatchNorm1d``, whose running variance is unbiased.

    With ``group`` set (``set_batchnorm_group``), the batch's statistics
    are those of the group's global batch: every rank's mean of x and of
    x^2 summed over the group, forward and backward, and divided by its
    size (each rank holds as many rows). A one-rank group changes
    nothing."""

    def __init__(self, dim: int, eps: float = 1e-5, momentum: float = 0.9):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.register_buffer("running_mean", torch.zeros(dim))
        self.register_buffer("running_var", torch.ones(dim))
        self.group = None

    def forward(self, x):
        xf = x.float()
        if self.training:
            dims = tuple(range(x.ndim - 1))
            mean, meansq = xf.mean(dims), torch.square(xf).mean(dims)
            if self.group is not None:
                stats = all_reduce_sum(torch.stack([mean, meansq]),
                                       self.group)
                n = group_size(self.group)
                mean, meansq = stats / n if n > 1 else stats
            var = torch.clamp(meansq - torch.square(mean), min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean
                                        + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        return ((xf - mean) * mul + self.bias).to(x.dtype)


class Dropout(nn.Module):
    """Flax's dropout: in training, x / keep where a Bernoulli(keep) draw
    is 1, else 0; the identity in eval or at rate 0. The draws come from
    ``self.generator``, which ``set_dropout_generator`` sets (a training
    forward with rate > 0 and no generator raises)."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = float(rate)
        self.generator = None

    def forward(self, x):
        if not self.training or self.rate == 0.0:
            return x
        if self.generator is None:
            raise RuntimeError("dropout in training needs a torch.Generator: "
                               "call set_dropout_generator(model, gen)")
        keep = 1.0 - self.rate
        draw = torch.empty(x.shape, device=x.device).bernoulli_(
            keep, generator=self.generator)
        return torch.where(draw.bool(), x / keep, torch.zeros_like(x))


def set_dropout_generator(model: nn.Module, generator) -> None:
    """Hand ``generator`` to every Dropout of ``model``."""
    for m in model.modules():
        if isinstance(m, Dropout):
            m.generator = generator


def set_batchnorm_group(model: nn.Module, group) -> None:
    """Take every BatchNorm's training statistics over ``group``."""
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.group = group


def _tp_split(n: int, group, what: str) -> int:
    parts = group_size(group)
    if n % parts:
        raise ValueError(f"{what} {n} does not split over {parts} ranks")
    return n // parts


class FeedForward(nn.Module):
    """Pre-LN FFN: drop(w2(drop(relu(w1(LN(x)))))); under ``tp_group``
    each rank holds d_inner / tp of the hidden units."""

    def __init__(self, d_model: int, d_inner: int, dropout_rate: float = 0.0,
                 tp_group=None):
        super().__init__()
        self.tp_group = tp_group
        d_local = _tp_split(d_inner, tp_group, "linear_units")
        self.layer_norm = LayerNorm(d_model)
        self.w1 = Dense(d_model, d_local)
        self.w2 = RowParallelDense(d_local, d_model, tp_group)
        self.drop = Dropout(dropout_rate)

    def forward(self, x):
        x = F.relu(self.w1(copy_to(self.layer_norm(x), self.tp_group)))
        return self.drop(self.w2(self.drop(x)))


class RelPosMultiHeadAttention(nn.Module):
    """MHSA with a relative-position key term:
    scores = (q k^T + q pos_k^T) / sqrt(d_k). Under ``tp_group`` each
    rank holds ``n_head`` (the local heads) = heads / tp of them."""

    def __init__(self, n_head: int, n_feat: int, dropout_rate: float = 0.0,
                 tp_group=None):
        super().__init__()
        self.tp_group = tp_group
        self.d_k = n_feat // n_head
        self.n_head = _tp_split(n_head, tp_group, "attention_heads")
        self.n_feat = n_feat
        self.width = self.n_head * self.d_k  # n_feat without TP
        self.layer_norm = LayerNorm(n_feat)
        self.linear_q = Dense(n_feat, self.width)
        self.linear_k = Dense(n_feat, self.width)
        self.linear_v = Dense(n_feat, self.width)
        self.linear_out = RowParallelDense(self.width, n_feat, tp_group)
        self.drop = Dropout(dropout_rate)

    def _heads(self, x):
        b, t, _ = x.shape
        return x.reshape(b, t, self.n_head, self.d_k).transpose(1, 2)

    def _qkv(self, x):
        x = copy_to(self.layer_norm(x), self.tp_group)
        return (self._heads(self.linear_q(x)), self._heads(self.linear_k(x)),
                self._heads(self.linear_v(x)))

    def _attend(self, q, k, v, pos_k, mask):
        """q (B, h, T, d), k and v (B, h, S, d), pos_k (T, S, d) or None,
        mask (T, S) bool or None -> (B, T, n_feat)."""
        return self.drop(self.linear_out(self._context(q, k, v, pos_k,
                                                       mask)))

    def _context(self, q, k, v, pos_k, mask):
        """The heads' attention-weighted values, (B, T, h * d)."""
        scores = q @ k.transpose(-1, -2)  # (B, h, T, S)
        if pos_k is not None:
            # the local heads' share of pe_k's gradient is summed over TP
            pos_k = copy_to(pos_k, self.tp_group)
            scores = scores + torch.einsum("bhtd,tsd->bhts", q,
                                           pos_k.to(q.dtype))
        scores = scores / math.sqrt(self.d_k)
        if mask is not None:
            scores = torch.where(mask, scores,
                                 torch.full((), -1e9, dtype=scores.dtype,
                                            device=scores.device))
        attn = self.drop(torch.softmax(scores.float(), dim=-1).to(q.dtype))
        out = attn @ v  # (B, h, T, d)
        b, h, t, d = q.shape
        return out.transpose(1, 2).reshape(b, t, h * d)

    def forward(self, x, pos_k, mask=None):
        """x (B, T, n_feat), pos_k (T, T, d_k) or None, mask (T, T) bool
        (True where query t may attend key s) or None."""
        return self._attend(*self._qkv(x), pos_k, mask)

    def stream(self, x, cache, pos_k, mask):
        """A chunk (B, Tc, n_feat) attending [cached left context | the
        chunk]. cache = (k (B, h, L, d), v (B, h, L, d), valid (L,) bool);
        pos_k (Tc, L + Tc, d) and mask (Tc, L + Tc) over that key axis.
        Returns (out, the cache rolled to the last L key positions)."""
        k_c, v_c, valid = cache
        q, k, v = self._qkv(x)
        k_all = torch.cat([k_c, k], dim=2)
        v_all = torch.cat([v_c, v], dim=2)
        valid_all = torch.cat([valid, valid.new_ones(q.shape[2])])
        out = self._attend(q, k_all, v_all, pos_k, mask & valid_all[None])
        n = k_c.shape[2]
        return out, (k_all[:, :, -n:], v_all[:, :, -n:], valid_all[-n:])


class ConvModule(nn.Module):
    """Scalar GLU -> depthwise conv over time -> BatchNorm -> ReLU ->
    scalar affine -> dropout. The reference's "pointwise" convs are
    Conv2d(1, 2, 1) / Conv2d(1, 1, 1) over a singleton channel, i.e. scalar
    affine maps: GLU(x) = (w0 x + b0) * sigmoid(w1 x + b1)."""

    def __init__(self, input_dim: int, kernel_size: int,
                 dropout_rate: float = 0.0, causal: bool = False):
        super().__init__()
        self.kernel_size = kernel_size
        self.causal = causal
        self.layer_norm = LayerNorm(input_dim)
        self.pw1_w = nn.Parameter(torch.ones(2))
        self.pw1_b = nn.Parameter(torch.zeros(2))
        self.dw_conv = nn.Conv1d(input_dim, input_dim, kernel_size,
                                 groups=input_dim)
        self.bn = BatchNorm(input_dim)
        self.pw2_w = nn.Parameter(torch.ones(1))
        self.pw2_b = nn.Parameter(torch.zeros(1))
        self.drop = Dropout(dropout_rate)

    def _glu(self, x):
        dt = x.dtype
        x = self.layer_norm(x)
        w, b = self.pw1_w.to(dt), self.pw1_b.to(dt)
        return (w[0] * x + b[0]) * torch.sigmoid(w[1] * x + b[1])

    def _dw_conv(self, x, padding: int = 0):
        """The depthwise conv over time of x (B, T, C), zero-padded by
        ``padding`` frames on each side."""
        dt = x.dtype
        return F.conv1d(x.transpose(1, 2), self.dw_conv.weight.to(dt),
                        self.dw_conv.bias.to(dt), padding=padding,
                        groups=self.dw_conv.groups).transpose(1, 2)

    def _post(self, x):
        dt = x.dtype
        x = F.relu(self.bn(x))
        return self.drop(self.pw2_w.to(dt)[0] * x + self.pw2_b.to(dt)[0])

    def forward(self, x):
        x, k = self._glu(x), self.kernel_size
        if self.causal:  # k - 1 zero frames before the first, none after
            return self._post(self._dw_conv(F.pad(x, (0, 0, k - 1, 0))))
        return self._post(self._dw_conv(x, (k - 1) // 2))

    def stream(self, x, tail):
        """A causal chunk (B, Tc, C) after the carried tail (B, k - 1, C) of
        GLU outputs -> (out, the new tail). A zero tail is the causal left
        padding, so chained chunks give the causal forward."""
        if not self.causal:
            raise ValueError("stream() requires causal=True")
        full = torch.cat([tail.to(x.dtype), self._glu(x)], dim=1)
        out = self._post(self._dw_conv(full))
        # kernel_size 1 carries no context ([-0:] would keep everything)
        return out, full[:, full.shape[1] - (self.kernel_size - 1):]


class EncoderLayer(nn.Module):
    """Conformer block with Macaron residuals and post-LN."""

    def __init__(self, d_model: int, n_head: int, d_ffn: int,
                 kernel_size: int, dropout_rate: float = 0.0,
                 causal: bool = False, tp_group=None):
        super().__init__()
        self.feed_forward_in = FeedForward(d_model, d_ffn, dropout_rate,
                                           tp_group)
        self.self_attn = RelPosMultiHeadAttention(n_head, d_model,
                                                  dropout_rate, tp_group)
        self.conv = ConvModule(d_model, kernel_size, dropout_rate, causal)
        self.feed_forward_out = FeedForward(d_model, d_ffn, dropout_rate,
                                            tp_group)
        self.layer_norm = LayerNorm(d_model)

    def forward(self, x, pos_k, mask=None):
        x = x + 0.5 * self.feed_forward_in(x)
        x = x + self.self_attn(x, pos_k, mask)
        x = x + self.conv(x)
        x = x + 0.5 * self.feed_forward_out(x)
        return self.layer_norm(x)

    def stream(self, x, state, pos_k, mask):
        """state = (the attention's KV cache, the conv tail)."""
        kv, tail = state
        x = x + 0.5 * self.feed_forward_in(x)
        a, kv = self.self_attn.stream(x, kv, pos_k, mask)
        x = x + a
        c, tail = self.conv.stream(x, tail)
        x = x + c
        x = x + 0.5 * self.feed_forward_out(x)
        return self.layer_norm(x), (kv, tail)


class ConformerEncoder(nn.Module):
    """Embedding + relative positions + N blocks; ``causal`` bands the
    attention to ``0 <= t - s < left_context``."""

    def __init__(self, idim: int = 257, attention_dim: int = 256,
                 attention_heads: int = 4, linear_units: int = 1024,
                 num_blocks: int = 16, kernel_size: int = 33,
                 relative_pos_emb: bool = True, maxlen: int = 1000,
                 dropout_rate: float = 0.0, causal: bool = False,
                 left_context: int = 128, tp_group=None):
        super().__init__()
        self.maxlen = maxlen
        self.causal = causal
        self.left_context = left_context
        self.embed_linear = Dense(idim, attention_dim)
        self.embed_norm = LayerNorm(attention_dim)
        self.embed_drop = Dropout(dropout_rate)
        self.pe_k = (nn.Parameter(torch.zeros(
            2 * maxlen, attention_dim // attention_heads))
            if relative_pos_emb else None)
        self.encoders = nn.ModuleList([
            EncoderLayer(attention_dim, attention_heads, linear_units,
                         kernel_size, dropout_rate, causal, tp_group)
            for _ in range(num_blocks)])

    def _offsets(self, t: int) -> torch.Tensor:
        """(T, T) frame offsets t - s."""
        pos = torch.arange(t, device=self.embed_linear.weight.device)
        return pos[:, None] - pos[None, :]

    def rel_pos(self, rel) -> torch.Tensor:
        """pe_k[clip(rel, -maxlen, maxlen-1) + maxlen] -> (T, S, d_k) for a
        (T, S) integer matrix of frame offsets, or for an int T the
        offsets t - s of T frames: a
        plain gather (the one-hot matmul of ``_relpos_band`` is a TPU
        device; both are exact). Differentiable: its backward is
        ``index_put_(accumulate=True)`` into pe_k's shape, which sums the
        T-|offset| copies of each offset. On the card that runs PyTorch's
        sort-based kernel, which adds each index's duplicates in a fixed
        order: deterministic from run to run (held bit-equal by a card test
        in tests/test_torch_cuda.py). On the CPU, index_put_ adds them in
        parallel with atomic adds when it has threads, in an order that
        changes from run to run; there the gather is ``index_select``,
        whose backward (``index_add_``) adds them in index order."""
        if isinstance(rel, int):
            rel = self._offsets(rel)
        idx = torch.clamp(rel, -self.maxlen, self.maxlen - 1) + self.maxlen
        if idx.device.type == "cpu":
            return self.pe_k.index_select(0, idx.reshape(-1)).reshape(
                *idx.shape, self.pe_k.shape[-1])
        return self.pe_k[idx]

    def _embed(self, xs):
        return F.relu(self.embed_drop(self.embed_norm(self.embed_linear(xs))))

    def forward(self, xs):
        xs = self._embed(xs)
        rel = self._offsets(xs.shape[1])
        pos_k = self.rel_pos(rel) if self.pe_k is not None else None
        mask = ((rel >= 0) & (rel < self.left_context) if self.causal
                else None)
        for enc in self.encoders:
            xs = enc(xs, pos_k, mask)
        return xs

    def stream(self, xs, state):
        """A causal chunk (B, Tc, idim) with each block's carried (KV cache,
        conv tail) -> (out, the new states). The key axis is [L cache slots
        | Tc chunk frames]: query i lies L + i - j frames after cache slot
        j and i - j after chunk frame j."""
        if not self.causal:
            raise ValueError("stream() requires causal=True")
        xs = self._embed(xs)
        tc, n = xs.shape[1], self.left_context
        dev = xs.device
        qi = torch.arange(tc, device=dev)[:, None]
        rel = torch.cat([n + qi - torch.arange(n, device=dev)[None, :],
                         qi - torch.arange(tc, device=dev)[None, :]], dim=1)
        pos_k = self.rel_pos(rel) if self.pe_k is not None else None
        mask = (rel >= 0) & (rel < n)
        states = []
        for enc, st in zip(self.encoders, state):
            xs, st = enc.stream(xs, st, pos_k, mask)
            states.append(st)
        return xs, tuple(states)


class Conformer(nn.Module):
    """Conformer mask-estimation model: features (B, T, F) -> (y_pred
    (B, num_spk, T, F), masks (B, T, F, num_spk + num_noise))."""

    def __init__(self, idim: int = 257, num_bins: int = 257, num_spk: int = 2,
                 num_noise: int = 1, attention_dim: int = 256,
                 attention_heads: int = 4, linear_units: int = 1024,
                 num_blocks: int = 16, kernel_size: int = 33,
                 relative_pos_emb: bool = True,
                 compute_dtype: torch.dtype = torch.float32,
                 dropout_rate: float = 0.1, causal: bool = False,
                 left_context: int = 128, tp_group=None):
        super().__init__()
        self.num_bins = num_bins
        self.num_spk = num_spk
        self.num_noise = num_noise
        self.compute_dtype = compute_dtype
        self.causal = causal
        self.left_context = left_context
        self.conformer = ConformerEncoder(
            idim, attention_dim, attention_heads, linear_units, num_blocks,
            kernel_size, relative_pos_emb, dropout_rate=dropout_rate,
            causal=causal, left_context=left_context, tp_group=tp_group)
        self.linear = Dense(attention_dim, num_bins * (num_spk + num_noise))

    @classmethod
    def build_model(cls, conf: Dict, tp_group=None) -> "Conformer":
        """From a checkpoint's conf (the css_tpu training flags); with
        ``tp_group``, this rank's tensor-parallel shard."""
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
            dropout_rate=float(conf.get("conformer_dropout_rate", 0.1)),
            causal=bool(conf.get("conformer_causal", False)),
            left_context=int(conf.get("conformer_left_context", 128)),
            tp_group=tp_group,
        )

    def _mask_head(self, x: torch.Tensor) -> torch.Tensor:
        n_src = self.num_spk + self.num_noise
        masks = F.relu(self.linear(x)).float()
        b, t, _ = masks.shape
        return masks.reshape(b, t, n_src, self.num_bins).transpose(2, 3)

    def forward(self, f) -> Tuple[torch.Tensor, torch.Tensor]:
        x = cumulative_mvn(f)[0] if self.causal else mvn(f, dim=-2)
        masks = self._mask_head(self.conformer(x.to(self.compute_dtype)))
        y_pred = torch.einsum("btfs,btf->bstf", masks[..., : self.num_spk],
                              f[..., : self.num_bins])
        return y_pred, masks

    # ------------------------------------------------------------- streaming
    def stream_init(self, batch: int = 1) -> Dict:
        """The zero carry of ``stream`` on the model's device: the running
        MVN's (count, sum, sumsq) and per block the KV cache (k, v in the
        compute dtype, (B, heads, left_context, d_k), and no slot valid)
        and the conv tail (B, kernel_size - 1, attention_dim)."""
        enc = self.conformer
        dev = enc.embed_linear.weight.device
        dt = self.compute_dtype
        att = enc.encoders[0].self_attn
        dim, heads = att.n_feat, att.n_head
        kern = enc.encoders[0].conv.kernel_size
        zeros_f = torch.zeros((batch, enc.embed_linear.in_features),
                              device=dev)
        kv_shape = (batch, heads, self.left_context, att.d_k)
        layers = tuple(
            ((torch.zeros(kv_shape, dtype=dt, device=dev),
              torch.zeros(kv_shape, dtype=dt, device=dev),
              torch.zeros(self.left_context, dtype=torch.bool, device=dev)),
             torch.zeros((batch, kern - 1, dim), dtype=dt, device=dev))
            for _ in enc.encoders)
        return {"mvn": (torch.zeros((), device=dev), zeros_f, zeros_f),
                "layers": layers}

    @torch.no_grad()
    def stream(self, f: torch.Tensor, carry: Dict):
        """Causal chunk forward: features (B, Tc, F) and the carry ->
        (masks (B, Tc, F, S), the new carry). Chained chunks give the
        causal offline forward's masks."""
        if not self.causal:
            raise ValueError("stream() requires a causal=True model")
        x, mvn_carry = cumulative_mvn(f, carry["mvn"])
        x, layers = self.conformer.stream(x.to(self.compute_dtype),
                                          carry["layers"])
        return self._mask_head(x), {"mvn": mvn_carry, "layers": layers}


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


def params_from_torch(state_dict, num_blocks: int = 16) -> Dict:
    """A reference torch Conformer state_dict (the reference's
    ``css/models/conformer.py`` names) -> the JAX package's
    {"params", "batch_stats"} numpy layout, leaf for leaf what
    ``css_tpu.models.conformer.params_from_torch`` gives; load it with
    ``params_from_jax``."""
    def t(name):
        return np.asarray(state_dict[name].detach().cpu().numpy())

    def dense(prefix):
        return {"kernel": t(f"{prefix}.weight").T, "bias": t(f"{prefix}.bias")}

    def ln(prefix):
        return {"scale": t(f"{prefix}.weight"), "bias": t(f"{prefix}.bias")}

    def ffn(prefix):
        return {"layer_norm": ln(f"{prefix}.layer_norm"),
                "w1": dense(f"{prefix}.net.0"),
                "w2": dense(f"{prefix}.net.3")}

    params = {
        "conformer": {
            "embed_linear": dense("conformer.embed.0"),
            "embed_norm": ln("conformer.embed.1"),
            "pe_k": t("conformer.pos_emb.pe_k.weight"),
        },
        "linear": dense("linear"),
    }
    batch_stats = {"conformer": {}}
    for i in range(num_blocks):
        p = f"conformer.encoders.{i}"
        params["conformer"][f"encoders_{i}"] = {
            "feed_forward_in": ffn(f"{p}.feed_forward_in"),
            "feed_forward_out": ffn(f"{p}.feed_forward_out"),
            "self_attn": {
                "layer_norm": ln(f"{p}.self_attn.layer_norm"),
                "linear_q": dense(f"{p}.self_attn.linear_q"),
                "linear_k": dense(f"{p}.self_attn.linear_k"),
                "linear_v": dense(f"{p}.self_attn.linear_v"),
                "linear_out": dense(f"{p}.self_attn.linear_out"),
            },
            "conv": {
                "layer_norm": ln(f"{p}.conv.layer_norm"),
                "pw1_w": t(f"{p}.conv.pw_conv_1.weight").reshape(2),
                "pw1_b": t(f"{p}.conv.pw_conv_1.bias").reshape(2),
                # torch depthwise (C, 1, K) -> the JAX layout (K, 1, C)
                "dw_kernel": t(f"{p}.conv.dw_conv_1d.weight").transpose(
                    2, 1, 0),
                "dw_bias": t(f"{p}.conv.dw_conv_1d.bias"),
                "bn": {"scale": t(f"{p}.conv.BN.weight"),
                       "bias": t(f"{p}.conv.BN.bias")},
                "pw2_w": t(f"{p}.conv.pw_conv_2.weight").reshape(1),
                "pw2_b": t(f"{p}.conv.pw_conv_2.bias").reshape(1),
            },
            "layer_norm": ln(f"{p}.layer_norm"),
        }
        batch_stats["conformer"][f"encoders_{i}"] = {"conv": {"bn": {
            "mean": t(f"{p}.conv.BN.running_mean"),
            "var": t(f"{p}.conv.BN.running_var")}}}
    return {"params": params, "batch_stats": batch_stats}
