"""The CSS BLSTM mask estimator, plainly (desh2608/css
``css/models/blstm.py``: hidden 1024, 512 a direction, 3 layers).

features (B, T, F) -> utterance MVN -> Linear, LayerNorm, ReLU -> per
layer a forward and a backward LSTM over the whole window, concatenated,
then LayerNorm -> ReLU(Linear) masks (B, T, F, S). An LSTM step, gate
order i, f, g, o, one bias a direction:

    i, f, g, o = x_t W_ih^T + b + h_{t-1} W_hh^T
    c_t = sigmoid(f) c_{t-1} + sigmoid(i) tanh(g)
    h_t = sigmoid(o) tanh(c_t)
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from bench_gpu.reference.dsp import mvn
from bench_gpu.reference.precision import mm

LN_EPS = 1e-5


def spec(cfg: Dict) -> List[Tuple[str, tuple, str]]:
    """(name, shape, initialiser) of every tensor, named as the program's
    state_dict (see ``conformer.spec``)."""
    hd, idim = cfg["hidden_dim"], cfg["idim"]
    h = hd // 2
    n_out = cfg["num_bins"] * (cfg["num_spk"] + cfg["num_noise"])
    out = [("embed_linear.weight", (hd, idim), "dense"),
           ("embed_linear.bias", (hd,), "zeros"),
           ("embed_norm.weight", (hd,), "ones"),
           ("embed_norm.bias", (hd,), "zeros")]
    for i in range(cfg["num_layers"]):
        for d in ("fwd", "bwd"):
            out += [(f"encoders.{i}.w_ih_{d}", (4 * h, hd), "dense"),
                    (f"encoders.{i}.w_hh_{d}", (4 * h, h), "dense"),
                    (f"encoders.{i}.b_{d}", (4 * h,), "zeros")]
        out += [(f"encoders.{i}.layer_norm.weight", (hd,), "ones"),
                (f"encoders.{i}.layer_norm.bias", (hd,), "zeros")]
    out += [("linear.weight", (n_out, hd), "dense"),
            ("linear.bias", (n_out,), "zeros")]
    return out


def _ln(p, name, x):
    return F.layer_norm(x, x.shape[-1:], p[f"{name}.weight"],
                        p[f"{name}.bias"], LN_EPS)


def lstm(xw: torch.Tensor, w_hh: torch.Tensor, reverse: bool,
         mode: str = "f32") -> torch.Tensor:
    """xw (B, T, 4h) input projections with the bias; w_hh (4h, h) ->
    hs (B, T, h)."""
    b, t, four_h = xw.shape
    h_dim = four_h // 4
    h = xw.new_zeros((b, h_dim))
    c = xw.new_zeros((b, h_dim))
    w = w_hh.t()
    hs = [None] * t
    for ti in (range(t - 1, -1, -1) if reverse else range(t)):
        i, f, g, o = (xw[:, ti] + mm(h, w, mode)).chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        hs[ti] = h
    return torch.stack(hs, dim=1)


def masks(p: Dict[str, torch.Tensor], feats: torch.Tensor, cfg: Dict,
          mode: str = "f32", train: bool = False) -> torch.Tensor:
    """features (B, T, F) float32 -> masks (B, T, F, S). ``train`` changes
    nothing (the benchmark runs dropout at 0)."""
    x = mvn(feats.float(), dim=-2)
    x = mm(x, p["embed_linear.weight"].t(), mode) + p["embed_linear.bias"]
    x = torch.relu(_ln(p, "embed_norm", x))
    for i in range(cfg["num_layers"]):
        outs = []
        for d in ("fwd", "bwd"):
            xw = (mm(x, p[f"encoders.{i}.w_ih_{d}"].t(), mode)
                  + p[f"encoders.{i}.b_{d}"])
            outs.append(lstm(xw, p[f"encoders.{i}.w_hh_{d}"], d == "bwd",
                             mode))
        x = _ln(p, f"encoders.{i}.layer_norm", torch.cat(outs, dim=-1))
    m = torch.relu(mm(x, p["linear.weight"].t(), mode) + p["linear.bias"])
    b, t, _ = m.shape
    s = cfg["num_spk"] + cfg["num_noise"]
    return m.reshape(b, t, s, cfg["num_bins"]).transpose(2, 3)
