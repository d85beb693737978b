"""Checkpoint averaging CLI (port of ``css_tpu/cli/combine.py``).

    python -m css_tpu_torch.cli.combine merged.mdl --models 3.1.mdl 3.2.mdl

Fraction-weighted averaging of per-job checkpoints, tolerating missing
jobs (renormalised over the survivors), then the inputs are deleted
unless --save-models. The float64 sums run on ``--device`` (default cuda;
it raises without a card unless told ``--device cpu``).
"""

from __future__ import annotations

import argparse
from pathlib import Path

from css_tpu_torch.device import resolve_device
from css_tpu_torch.trainer import checkpoint
from css_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("output", help="merged checkpoint path")
    parser.add_argument("--models", nargs="+", required=True,
                        help="per-job checkpoints to average")
    parser.add_argument("--save-models", action="store_true",
                        help="keep the per-job checkpoints")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    merged = checkpoint.average_checkpoints(args.models,
                                            resolve_device(args.device))
    checkpoint.save_checkpoint_dict(args.output, merged)
    survivors = [m for m in args.models if Path(m).exists()]
    log.info("Averaged %d/%d checkpoints -> %s", len(survivors),
             len(args.models), args.output)
    if not args.save_models:
        for m in survivors:
            Path(m).unlink()


if __name__ == "__main__":
    main()
