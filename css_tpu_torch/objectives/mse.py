"""Permutation-invariant MSE on masked spectrograms (port of
``css_tpu/objectives/mse.py``), with the optional noise-mask term, the
canonical-order term and the cross-window consistency term."""

from __future__ import annotations

import torch

from css_tpu_torch.objectives.base import source_keys
from css_tpu_torch.ops.pit import batch_pit_loss, mse_pairwise


class MeanSquaredError:
    """PIT-MSE of y_pred against the source magnitudes, plus:
      * ``noise_weight``: mean((noise_mask*|mix| - relu(|mix| - sum|s_k|))^2),
        which teaches the last mask the non-speech residual;
      * ``order_weight``: a per-example blend of the PIT loss with the loss
        under the canonical order (slot k = k-th lowest spectral centroid),
        gated by sigmoid((centroid gap - 4) / 2) so that ambiguous pairs
        keep pure PIT;
      * ``consistency_weight``: the trainer featurizes each window twice as
        crops offset by ``consistency_frames`` frames (rows [B:] of the
        masks); the two masks' disagreement on the shared frames is
        penalised and PIT is trained on the first crop only."""

    def __init__(self, noise_weight: float = 0.0, order_weight: float = 0.0,
                 consistency_weight: float = 0.0,
                 consistency_frames: int = 25):
        self.noise_weight = noise_weight
        self.order_weight = order_weight
        self.consistency_weight = consistency_weight
        self.consistency_frames = int(consistency_frames)

    @staticmethod
    def add_args(parser):
        parser.add_argument("--mse-noise-weight", type=float, default=0.0,
                            help="weight of the noise-mask residual term")
        parser.add_argument("--mse-order-weight", type=float, default=0.0,
                            help="canonical slot-ordering pressure (slot 0 = "
                                 "lower spectral-centroid speaker), gated "
                                 "by the centroid gap")
        parser.add_argument("--mse-consistency-weight", type=float,
                            default=0.0,
                            help="cross-window mask-consistency term: each "
                                 "window is featurized twice as two crops "
                                 "offset by --mse-consistency-frames frames")
        parser.add_argument("--mse-consistency-frames", type=int, default=25,
                            help="crop offset in STFT frames")

    @classmethod
    def build_objective(cls, conf):
        return cls(noise_weight=float(conf.get("mse_noise_weight", 0.0)),
                   order_weight=float(conf.get("mse_order_weight", 0.0)),
                   consistency_weight=float(
                       conf.get("mse_consistency_weight", 0.0)),
                   consistency_frames=int(
                       conf.get("mse_consistency_frames", 25)))

    def __call__(self, outputs, batch):
        """outputs: y_pred (B, K, T, F) or (y_pred, masks (B, T, F, S));
        batch: 'input' and source1..K magnitudes (B, T, F)."""
        if isinstance(outputs, tuple):
            y_pred, masks = outputs[0], outputs[1]
        else:
            y_pred, masks = outputs, None
        src_keys = source_keys(batch)
        y_true = torch.stack([batch[k] for k in src_keys], dim=1)
        aux_cons = None
        mag_in = batch.get("input")
        b = y_true.shape[0]
        if (self.consistency_weight and masks is not None
                and masks.shape[0] == 2 * b):
            sf = self.consistency_frames
            m1, m2 = masks[:b], masks[b:]
            aux_cons = torch.mean(
                torch.square(m1[:, sf:] - m2[:, : m1.shape[1] - sf]))
            y_pred, masks = y_pred[:b], m1
            if mag_in is not None:
                mag_in = mag_in[:b]
        rows = torch.arange(b, device=y_true.device)[:, None]
        if self.order_weight:
            # canonical target order by energy-weighted spectral centroid:
            # permutation bookkeeping on the targets, no gradient path
            f_idx = torch.arange(y_true.shape[-1], dtype=y_true.dtype,
                                 device=y_true.device)
            power = torch.sum(y_true, dim=(2, 3))  # (B, K)
            centroid = (torch.sum(y_true * f_idx, dim=(2, 3))
                        / torch.clamp(power, min=1e-6))
            order = torch.argsort(centroid, dim=1, stable=True)
            y_canon = y_true[rows, order]
            sorted_c = torch.gather(centroid, 1, order)
            gap = torch.min(torch.diff(sorted_c, dim=1), dim=1).values
            conf = torch.sigmoid((gap - 4.0) / 2.0)
            per_ex_canon = torch.mean(torch.square(y_pred - y_canon),
                                      dim=(1, 2, 3))
            y_true = y_canon
        loss, perms = batch_pit_loss(y_pred, y_true, loss_fn=mse_pairwise)
        aux = {"perms": perms}
        if self.order_weight:
            # clamped so that order_weight > 1 cannot give PIT a negative
            # weight
            w = torch.clamp(self.order_weight * conf, 0.0, 1.0)
            aux["order_gap"] = torch.mean(per_ex_canon) - loss
            per_ex_pit = torch.mean(
                torch.square(y_pred[rows, perms] - y_true), dim=(1, 2, 3))
            loss = torch.mean((1.0 - w) * per_ex_pit + w * per_ex_canon)
        if self.noise_weight and masks is not None and mag_in is not None:
            mag = mag_in[..., : y_true.shape[-1]]
            residual = torch.clamp(
                mag - sum(batch[k] for k in src_keys), min=0.0)
            noise_pred = masks[..., -1] * mag
            noise_loss = torch.mean(torch.square(noise_pred - residual))
            aux["noise_loss"] = noise_loss
            loss = loss + self.noise_weight * noise_loss
        if aux_cons is not None:
            aux["consistency"] = aux_cons
            loss = loss + self.consistency_weight * aux_cons
        return loss, aux
