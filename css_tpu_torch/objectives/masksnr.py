"""Time-domain SI-SNR for spectrogram-mask models (port of
``css_tpu/objectives/masksnr.py``): est_k = iSTFT(mask_k * STFT(mix)),
loss = PIT(-clamped SI-SNR). The resynthesis is the matrix-product STFT
and iSTFT of ``ops/stft.py``, so autograd differentiates through it, as
the JAX package differentiates through XLA's. The masked-iSTFT kernel (K1)
has no backward and is not used here."""

from __future__ import annotations

import torch

from css_tpu_torch.objectives.base import source_keys
from css_tpu_torch.objectives.snr import si_snr
from css_tpu_torch.ops.pit import batch_pit_loss, mse_pairwise
from css_tpu_torch.ops.stft import istft, stft


class MaskSiSnr:
    """PIT SI-SNR on the masked-iSTFT resynthesis of mask-model outputs."""

    # the trainer hands this objective the waveforms (mix_wav, sourceK)
    needs_waveforms = True

    def __init__(self, frame_len: int = 512, frame_hop: int = 256,
                 mag_weight: float = 0.0, clamp_db: float = 30.0):
        self.frame_len = frame_len
        self.frame_hop = frame_hop
        self.mag_weight = mag_weight
        self.clamp_db = clamp_db

    @staticmethod
    def add_args(parser):
        parser.add_argument("--masksnr-mag-weight", type=float, default=0.0,
                            help="auxiliary magnitude-MSE weight")
        parser.add_argument("--masksnr-clamp-db", type=float, default=30.0,
                            help="clamp per-stream SI-SNR to +-this many dB")

    @classmethod
    def build_objective(cls, conf):
        return cls(frame_len=int(conf.get("frame_len", 512)),
                   frame_hop=int(conf.get("frame_hop", 256)),
                   mag_weight=float(conf.get("masksnr_mag_weight", 0.0)),
                   clamp_db=float(conf.get("masksnr_clamp_db", 30.0)))

    def __call__(self, outputs, batch):
        """outputs: (y_pred, masks (B, T, F, S)); batch: mix_wav (B, N) and
        source1..K waveforms (B, N)."""
        if not (isinstance(outputs, tuple) and len(outputs) >= 2):
            raise ValueError(
                "MaskSNR needs a mask model returning (y_pred, masks); "
                "use objective SNR for time-domain models")
        masks = outputs[1]
        src_keys = source_keys(batch)
        k = len(src_keys)
        mix = batch["mix_wav"]
        n = mix.shape[-1]
        spec = stft(mix, self.frame_len, self.frame_hop)  # (B, T, F)
        speech = masks[..., :k].permute(0, 3, 1, 2)  # (B, K, T, F)
        est = istft(speech * spec[:, None], self.frame_len, self.frame_hop,
                    length=n)
        y_true = torch.stack([batch[sk][..., :n] for sk in src_keys], dim=1)
        clamp = self.clamp_db

        def neg_clamped_si_snr(e, r):
            return -torch.mean(torch.clamp(si_snr(e, r), -clamp, clamp))

        loss, perms = batch_pit_loss(est, y_true, loss_fn=neg_clamped_si_snr)
        aux = {"perms": perms, "si_snr": -loss}
        if self.mag_weight:
            y_pred_mag = speech * torch.abs(spec)[:, None]
            true_mag = torch.abs(stft(y_true, self.frame_len, self.frame_hop))
            # the SI-SNR winner's permutation, not an independent PIT
            rows = torch.arange(perms.shape[0], device=perms.device)[:, None]
            mag_loss = mse_pairwise(y_pred_mag[rows, perms], true_mag)
            aux["mag_loss"] = mag_loss
            loss = loss + self.mag_weight * mag_loss
        return loss, aux
