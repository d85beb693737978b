"""Mask-model training steps, plainly: magnitude features, PIT-MSE with
the noise-mask term, the global-norm clip and Adam with an L2 term.

One step on a batch of waveforms (mix (B, N), sources (K, B, N)):

  1. |STFT| of the mixture and each source (``dsp.stft_mag``);
  2. masks = model(|mix|) in training mode (BatchNorm on the batch's
     statistics); estimates y_k = masks_k * |mix|;
  3. loss = mean over examples of min over the K! orders p of
     mean((y_p(k) - |s_k|)^2) over (K, T, F), plus ``noise_weight`` *
     mean((masks_noise * |mix| - relu(|mix| - sum_k |s_k|))^2);
  4. g = grad(loss); clipped: g * thresh / |g| where |g| >= thresh (|g|
     the global norm);
  5. Adam (b1 0.9, b2 0.999, eps 1e-8) on g + wd * p, bias-corrected by
     the update count c: p -= lr(c - 1) * m_hat / (sqrt(v_hat) + eps);
     lr(n) = min_lr + (lr - min_lr) * n / warmup while n <= warmup, then
     lr * exp(-decay * (n - warmup)).
"""

from __future__ import annotations

import itertools
import math
from typing import Dict, List

import torch

from bench_gpu.reference import dsp

B1, B2, EPS = 0.9, 0.999, 1e-8


def rate(hyper: Dict, n: int) -> float:
    lr, warm = hyper["lr"], hyper.get("warmup", 0)
    min_lr = hyper.get("min_lr", 1e-9)
    if warm > 0 and n <= warm:
        return min_lr + (lr - min_lr) * n / warm
    return lr * math.exp(-hyper.get("decay", 0.0) * max(n - warm, 0))


def loss_fn(masks: torch.Tensor, mix_mag: torch.Tensor,
            src_mags: List[torch.Tensor], noise_weight: float
            ) -> torch.Tensor:
    k = len(src_mags)
    est = masks[..., :k] * mix_mag[..., None]  # (B, T, F, K)
    ref = torch.stack(src_mags, dim=-1)
    per_order = torch.stack([
        torch.square(est[..., list(p)] - ref).mean(dim=(1, 2, 3))
        for p in itertools.permutations(range(k))], dim=1)  # (B, K!)
    loss = per_order.min(dim=1).values.mean()
    if noise_weight:
        residual = torch.clamp(mix_mag - sum(src_mags), min=0.0)
        loss = loss + noise_weight * torch.mean(
            torch.square(masks[..., -1] * mix_mag - residual))
    return loss


class Adam:
    """The optimiser's state over a dict of leaves."""

    def __init__(self, params: Dict[str, torch.Tensor], hyper: Dict):
        self.hyper = hyper
        self.count = 0
        self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def update(self, params: Dict[str, torch.Tensor],
               grads: Dict[str, torch.Tensor]) -> float:
        """Clip, add the L2 term, one Adam step in place; returns the
        pre-clip global norm."""
        h = self.hyper
        norm = math.sqrt(sum(float(torch.sum(torch.square(g.double())))
                             for g in grads.values()))
        scale = 1.0 if norm < h["grad_thresh"] else h["grad_thresh"] / norm
        lr = rate(h, self.count)
        self.count += 1
        c1, c2 = 1 - B1 ** self.count, 1 - B2 ** self.count
        for k, p in params.items():
            g = grads[k] * scale + h["weight_decay"] * p
            self.mu[k].mul_(B1).add_((1 - B1) * g)
            self.nu[k].mul_(B2).add_((1 - B2) * torch.square(g))
            p.sub_(lr * (self.mu[k] / c1)
                   / (torch.sqrt(self.nu[k] / c2) + EPS))
        return norm


def step(params: Dict[str, torch.Tensor], opt: Adam, batch: Dict,
         mask_fn, hyper: Dict) -> Dict:
    """One training step in place on float32 ``params`` (the trainable
    leaves; buffers ride along untouched). ``mask_fn(params, mags)``
    gives the model's training-mode masks. Returns the step's loss and
    its raw gradients."""
    src_keys = sorted((k for k in batch if k.startswith("source")),
                      key=lambda s: int(s[6:]))
    wavs = torch.cat([batch["mix"]] + [batch[k] for k in src_keys])
    with torch.no_grad():
        mags = dsp.stft_mag(wavs).split(batch["mix"].shape[0])
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()
              if k in hyper["trainable"]}
    masks = mask_fn({**params, **leaves}, mags[0])
    loss = loss_fn(masks, mags[0], list(mags[1:]), hyper["noise_weight"])
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(
        leaves.values()))))
    opt.update({k: params[k] for k in leaves}, grads)
    return {"loss": float(loss.detach()), "grads": grads}
