"""Scale-invariant SNR objective for time-domain models (port of
``css_tpu/objectives/snr.py``): SI-SNR with PIT over speakers."""

from __future__ import annotations

import torch

from css_tpu_torch.objectives.base import source_keys
from css_tpu_torch.ops.pit import batch_pit_loss

EPS = 1e-8


def si_snr(est: torch.Tensor, ref: torch.Tensor,
           eps: float = EPS) -> torch.Tensor:
    """SI-SNR in dB over the last axis; inputs (..., N)."""
    est = est - torch.mean(est, dim=-1, keepdim=True)
    ref = ref - torch.mean(ref, dim=-1, keepdim=True)
    dot = torch.sum(est * ref, dim=-1, keepdim=True)
    energy = torch.sum(ref * ref, dim=-1, keepdim=True)
    proj = dot * ref / (energy + eps)
    noise = est - proj
    ratio = (torch.sum(proj * proj, dim=-1)
             / (torch.sum(noise * noise, dim=-1) + eps))
    return 10.0 * torch.log10(ratio + eps)


def neg_si_snr_pairwise(est, ref):
    """Mean negative SI-SNR over all leading axes (a PIT loss_fn)."""
    return -torch.mean(si_snr(est, ref))


class SiSnrObjective:
    @staticmethod
    def add_args(parser):
        pass

    @classmethod
    def build_objective(cls, conf):
        return cls()

    def __call__(self, outputs, batch):
        """outputs: (B, K, N) waveforms (or a tuple led by them); batch:
        source1..K waveforms (B, N)."""
        y_pred = outputs[0] if isinstance(outputs, tuple) else outputs
        src_keys = source_keys(batch)
        n = min(y_pred.shape[-1], batch[src_keys[0]].shape[-1])
        y_true = torch.stack([batch[k][..., :n] for k in src_keys], dim=1)
        loss, perms = batch_pit_loss(y_pred[..., :n], y_true,
                                     loss_fn=neg_si_snr_pairwise)
        return loss, {"perms": perms, "si_snr": -loss}
