"""The CSS Conformer mask estimator, plainly (Chen et al., "Continuous
Speech Separation with Conformer", arXiv:2008.05773; the layout of
desh2608/css ``css/models/conformer.py``).

features (B, T, F) -> utterance MVN -> Linear, LayerNorm, ReLU -> N blocks
-> ReLU(Linear) masks (B, T, F, S). A block, with Macaron half-FFNs and a
closing LayerNorm:

    x += 0.5 * W2 relu(W1 LN(x))
    x += Wo MHSA(LN(x)), scores (q k^T + q pos_k^T) / sqrt(d_k), pos_k a
         learned table over the clipped offsets t - s
    x += a2 * relu(BN(dwconv(glu(LN(x))))) + b2, glu(y) = (a0 y + b0)
         * sigmoid(a1 y + b1) with scalars a, b (1x1 convs over one
         channel), the depthwise conv zero-padded to keep T frames
    x += 0.5 * W2' relu(W1' LN(x))
    x = LN(x)

LayerNorm eps 1e-5; BatchNorm eps 1e-5, on the running statistics in eval
and on the batch's (mean, biased variance) in training. ``train`` turns on
BatchNorm's batch statistics only: the benchmark runs dropout at 0.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from bench_gpu.reference.dsp import mvn
from bench_gpu.reference.precision import mm

LN_EPS = BN_EPS = 1e-5


def spec(cfg: Dict) -> List[Tuple[str, tuple, str]]:
    """(name, shape, initialiser) of every tensor, the names those of the
    program's state_dict. Initialisers: ``dense`` (normal over sqrt of
    fan-in), ``normal``, ``ones``, ``zeros``, ``prelu``-free."""
    d, f = cfg["attention_dim"], cfg["linear_units"]
    idim, k = cfg["idim"], cfg["kernel_size"]
    dk = d // cfg["attention_heads"]
    n_out = cfg["num_bins"] * (cfg["num_spk"] + cfg["num_noise"])
    out = [("conformer.pe_k", (2 * cfg["maxlen"], dk), "normal"),
           ("conformer.embed_linear.weight", (d, idim), "dense"),
           ("conformer.embed_linear.bias", (d,), "zeros"),
           ("conformer.embed_norm.weight", (d,), "ones"),
           ("conformer.embed_norm.bias", (d,), "zeros")]

    def ln(p):
        return [(f"{p}.weight", (d,), "ones"), (f"{p}.bias", (d,), "zeros")]

    def dense(p, n_in, n_o):
        return [(f"{p}.weight", (n_o, n_in), "dense"),
                (f"{p}.bias", (n_o,), "zeros")]

    for i in range(cfg["num_blocks"]):
        b = f"conformer.encoders.{i}"
        for ff in ("feed_forward_in", "feed_forward_out"):
            out += (ln(f"{b}.{ff}.layer_norm") + dense(f"{b}.{ff}.w1", d, f)
                    + dense(f"{b}.{ff}.w2", f, d))
        out += ln(f"{b}.self_attn.layer_norm")
        for lin in ("linear_q", "linear_k", "linear_v", "linear_out"):
            out += dense(f"{b}.self_attn.{lin}", d, d)
        c = f"{b}.conv"
        out += [(f"{c}.pw1_w", (2,), "normal"), (f"{c}.pw1_b", (2,), "zeros"),
                (f"{c}.pw2_w", (1,), "ones"), (f"{c}.pw2_b", (1,), "zeros")]
        out += ln(f"{c}.layer_norm")
        out += [(f"{c}.dw_conv.weight", (d, 1, k), "dense"),
                (f"{c}.dw_conv.bias", (d,), "zeros"),
                (f"{c}.bn.weight", (d,), "ones"), (f"{c}.bn.bias", (d,), "zeros"),
                (f"{c}.bn.running_mean", (d,), "zeros"),
                (f"{c}.bn.running_var", (d,), "ones")]
        out += ln(f"{b}.layer_norm")
    out += dense("linear", d, n_out)
    return out


def _dense(p, name, x, mode):
    return mm(x, p[f"{name}.weight"].t(), mode) + p[f"{name}.bias"]


def _ln(p, name, x):
    return F.layer_norm(x, x.shape[-1:], p[f"{name}.weight"],
                        p[f"{name}.bias"], LN_EPS)


def _ffn(p, name, x, mode):
    h = torch.relu(_dense(p, f"{name}.w1", _ln(p, f"{name}.layer_norm", x),
                          mode))
    return _dense(p, f"{name}.w2", h, mode)


def _mhsa(p, name, x, pos_k, heads, mode):
    b, t, d = x.shape
    dk = d // heads
    y = _ln(p, f"{name}.layer_norm", x)

    def split(z):
        return z.reshape(b, t, heads, dk).transpose(1, 2)  # (B, h, T, dk)

    q = split(_dense(p, f"{name}.linear_q", y, mode))
    k = split(_dense(p, f"{name}.linear_k", y, mode))
    v = split(_dense(p, f"{name}.linear_v", y, mode))
    scores = mm(q, k.transpose(-1, -2), mode)
    # q . pos_k[t, s] for every (t, s): per query frame t, (B*h, dk) @
    # (dk, S)
    qt = q.permute(2, 0, 1, 3).reshape(t, b * heads, dk)
    rel = mm(qt, pos_k.transpose(-1, -2), mode)  # (T, B*h, S)
    scores = scores + rel.reshape(t, b, heads, t).permute(1, 2, 0, 3)
    attn = torch.softmax(scores / math.sqrt(dk), dim=-1)
    ctx = mm(attn, v, mode).transpose(1, 2).reshape(b, t, d)
    return _dense(p, f"{name}.linear_out", ctx, mode)


def _bn(p, name, x, train):
    if train:
        mean = x.mean(dim=(0, 1))
        var = torch.clamp(torch.square(x).mean(dim=(0, 1))
                          - torch.square(mean), min=0.0)
    else:
        mean, var = p[f"{name}.running_mean"], p[f"{name}.running_var"]
    return ((x - mean) * (torch.rsqrt(var + BN_EPS) * p[f"{name}.weight"])
            + p[f"{name}.bias"])


def _conv(p, name, x, train):
    y = _ln(p, f"{name}.layer_norm", x)
    a, c = p[f"{name}.pw1_w"], p[f"{name}.pw1_b"]
    y = (a[0] * y + c[0]) * torch.sigmoid(a[1] * y + c[1])
    w = p[f"{name}.dw_conv.weight"]
    y = F.conv1d(y.transpose(1, 2), w, p[f"{name}.dw_conv.bias"],
                 padding=(w.shape[-1] - 1) // 2, groups=w.shape[0])
    y = torch.relu(_bn(p, f"{name}.bn", y.transpose(1, 2), train))
    return p[f"{name}.pw2_w"][0] * y + p[f"{name}.pw2_b"][0]


def masks(p: Dict[str, torch.Tensor], feats: torch.Tensor, cfg: Dict,
          mode: str = "f32", train: bool = False) -> torch.Tensor:
    """features (B, T, F) float32 -> masks (B, T, F, S), S = speakers then
    noise."""
    x = mvn(feats.float(), dim=-2)
    x = torch.relu(_ln(p, "conformer.embed_norm",
                       _dense(p, "conformer.embed_linear", x, mode)))
    t = x.shape[1]
    pos = torch.arange(t, device=x.device)
    maxlen = p["conformer.pe_k"].shape[0] // 2
    rel = torch.clamp(pos[:, None] - pos[None, :], -maxlen, maxlen - 1)
    pos_k = p["conformer.pe_k"][rel + maxlen]  # (T, S, dk)
    for i in range(cfg["num_blocks"]):
        b = f"conformer.encoders.{i}"
        x = x + 0.5 * _ffn(p, f"{b}.feed_forward_in", x, mode)
        x = x + _mhsa(p, f"{b}.self_attn", x, pos_k, cfg["attention_heads"],
                      mode)
        x = x + _conv(p, f"{b}.conv", x, train)
        x = x + 0.5 * _ffn(p, f"{b}.feed_forward_out", x, mode)
        x = _ln(p, f"{b}.layer_norm", x)
    m = torch.relu(_dense(p, "linear", x, mode))
    b_, t_, _ = m.shape
    s = cfg["num_spk"] + cfg["num_noise"]
    return m.reshape(b_, t_, s, cfg["num_bins"]).transpose(2, 3)
