#!/usr/bin/env python3
"""The held-out probe's SI-SNRi of the committed flagship on the CPU, in
css_tpu and in the port, on the probe material chip_smoke.py's phase 7
(d) uses:

    JAX_PLATFORMS=cpu python scripts/torch_probe_reference.py

The flagship (checkpoints/h2ft_masksnr_best.mdl) in float32 compute, mask
mode, on the probe of the flagship's own training run (its checkpoint's
conf: the formant voice with fundamentals up to 400 Hz, 6 speakers x 4
utterances, seed 456; sessions of 12 s), 2 sessions. Prints one JSON
line: css_tpu's value (the one chip_smoke.py holds the card to), the
port's value on the CPU, and their difference. Needs JAX (the reference
package), so it runs beside the reference, not on the card machine.
"""

from __future__ import annotations

import json
import os
import sys
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

CHECKPOINT = "checkpoints/h2ft_masksnr_best.mdl"
PROBE = dict(sessions=2, session_sec=12.0, seed=456)
CORPUS = dict(num_speakers=6, utts_per_speaker=4, seed=456, f0_max=400.0,
              voice="formant")


def main() -> int:
    import jax

    jax.config.update("jax_platforms", "cpu")
    import torch

    from css_tpu.data.corpus import SyntheticCorpus as JCorpus
    from css_tpu.models import MODELS
    from css_tpu.trainer import checkpoint as jckpt
    from css_tpu.trainer.probe import HeldOutProbe as JProbe
    from css_tpu_torch.cli.separate import load_model
    from css_tpu_torch.data.corpus import SyntheticCorpus as TCorpus
    from css_tpu_torch.trainer.probe import HeldOutProbe as TProbe

    ckpt = jckpt.load_checkpoint(CHECKPOINT)
    conf = dict(ckpt.get("conf", {}), bf16=False)
    jmodel = MODELS["Conformer"].build_model(conf)
    variables = {"params": ckpt["params"]}
    if ckpt.get("batch_stats"):
        variables["batch_stats"] = ckpt["batch_stats"]
    want = JProbe(JCorpus(**CORPUS), mode="mask", **PROBE)(jmodel, variables)

    tmodel = load_model(CHECKPOINT)
    tmodel.compute_dtype = torch.float32
    got = TProbe(TCorpus(**CORPUS), mode="mask", device="cpu",
                 **PROBE)(tmodel)
    print(json.dumps({"checkpoint": CHECKPOINT, "probe": PROBE,
                      "corpus": CORPUS, "css_tpu_si_snri_db": want,
                      "port_cpu_si_snri_db": got,
                      "difference_db": got - want}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
