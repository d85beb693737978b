"""Import a reference torch ``.mdl`` checkpoint into the npz checkpoint
format (port of ``css_tpu/cli/import_torch.py``).

The reference's checkpoints are torch pickles of {model, objective,
optimizer, lr_sched, epoch, loss}. The model's weights go through the
port's per-model converters (``models.*.params_from_torch``) into the
layout both packages read, and are written by the port's
``save_checkpoint_dict`` with the keys ``css_tpu``'s importer writes, so
the result serves or fine-tunes in either package.

    python -m css_tpu_torch.cli.import_torch ref.mdl out.mdl \\
        --model Conformer [--num-blocks 16]
"""

from __future__ import annotations

import argparse

import torch

from css_tpu_torch.models import blstm, conformer, conv_tasnet
from css_tpu_torch.trainer.checkpoint import save_checkpoint_dict
from css_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("input", help="reference .mdl (torch pickle)")
    parser.add_argument("output", help="npz checkpoint path")
    parser.add_argument("--model", required=True,
                        choices=["Conformer", "BLSTM", "ConvTasNet"])
    parser.add_argument("--num-blocks", type=int, default=16,
                        help="Conformer blocks / ConvTasNet repeats")
    parser.add_argument("--num-layers", type=int, default=3,
                        help="BLSTM layers / ConvTasNet blocks-per-repeat")
    parser.add_argument("--norm", default="gln", help="ConvTasNet norm")
    args = parser.parse_args(argv)

    ckpt = torch.load(args.input, map_location="cpu", weights_only=False)
    state_dict = ckpt["model"] if "model" in ckpt else ckpt
    if args.model == "Conformer":
        variables = conformer.params_from_torch(state_dict,
                                                num_blocks=args.num_blocks)
    elif args.model == "BLSTM":
        variables = blstm.params_from_torch(state_dict,
                                            num_layers=args.num_layers)
    else:
        variables = conv_tasnet.params_from_torch(
            state_dict, num_layers=args.num_layers,
            num_blocks=args.num_blocks, norm=args.norm)
    meta = ckpt if isinstance(ckpt, dict) else {}
    save_checkpoint_dict(args.output, {
        "params": variables["params"],
        "batch_stats": variables.get("batch_stats", {}),
        "opt_state": {},
        "step": 0,
        "epoch": int(meta.get("epoch", 0)),
        "loss": float(meta.get("loss", 0.0)),
        "conf": {"imported_from": args.input, "model": args.model},
    })
    log.info("Imported %s (%s) -> %s", args.input, args.model, args.output)


if __name__ == "__main__":
    main()
