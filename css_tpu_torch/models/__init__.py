"""Mask-estimation models (the Conformer; BLSTM and Conv-TasNet wait for
ROADMAP.md Queue 1 item 7)."""

from css_tpu_torch.models.conformer import Conformer

MODELS = {"Conformer": Conformer}


def build_model(name: str, conf: dict):
    if name not in MODELS:
        raise KeyError(f"model {name!r} is not ported; available: "
                       f"{sorted(MODELS)}")
    return MODELS[name].build_model(conf)
