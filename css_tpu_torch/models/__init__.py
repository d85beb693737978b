"""Mask-estimation models (Conformer and BLSTM; Conv-TasNet waits for
ROADMAP.md Queue 1 item 7). Each model brings its converter from the JAX
package's checkpoint layout."""

from typing import Dict

import torch

from css_tpu_torch.models import blstm, conformer

MODELS = {"Conformer": conformer.Conformer, "BLSTM": blstm.BLSTM}
CONVERTERS = {
    "Conformer": lambda ckpt: conformer.params_from_jax(
        ckpt["params"], ckpt.get("batch_stats")),
    "BLSTM": lambda ckpt: blstm.params_from_jax(ckpt["params"]),
}


def build_model(name: str, conf: dict):
    if name not in MODELS:
        raise KeyError(f"model {name!r} is not ported; available: "
                       f"{sorted(MODELS)}")
    return MODELS[name].build_model(conf)


def state_dict_from_checkpoint(name: str,
                               ckpt: Dict) -> Dict[str, torch.Tensor]:
    """A loaded ``.mdl`` checkpoint -> the ``name`` model's state_dict."""
    return CONVERTERS[name](ckpt)
