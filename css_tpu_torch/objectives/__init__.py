"""Training objectives: PIT magnitude MSE, SI-SNR and masked-resynthesis
SI-SNR (port of ``css_tpu/objectives``). Each maps (model outputs, the
featurized batch) to (loss, aux)."""

from css_tpu_torch.objectives import masksnr, mse, snr
from css_tpu_torch.objectives.base import OBJECTIVES, source_keys

__all__ = ["OBJECTIVES", "build_objective", "source_keys"]

OBJECTIVES.update({"MSE": mse.MeanSquaredError, "SNR": snr.SiSnrObjective,
                   "MaskSNR": masksnr.MaskSiSnr})


def build_objective(name: str, conf: dict):
    return OBJECTIVES[name].build_objective(conf)
