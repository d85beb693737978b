"""Export a checkpoint's window forward with ``torch.export`` (port of
``css_tpu/cli/export.py``).

The eval-mode forward ``features -> clamp(masks, max=1)`` at one fixed
float32 (batch, frames, feature_dim) is traced by ``torch.export`` and
written with ``torch.export.save`` (a ``.pt2`` archive) that any process
with this package imported can serve without the Python model: the
Separator serves it through ``exported_path=``. The BLSTM's LSTM
recurrence is the registered op ``css_tpu_torch::lstm_fused``
(``ops/lstm_cuda.py``), so its artifact keeps K2 as one graph node per
(layer, direction), and a loaded artifact launches K2 on the card as the
live model does; so does a Conformer exported on the card with its conv
modules (``css_tpu_torch::conv_module``, ``ops/conv_module_cuda.py``, one
node a block) and its LayerNorms with their residual adds
(``css_tpu_torch::add_layer_norm``, ``ops/add_layer_norm_cuda.py``, four
nodes a block and one for the embedding). ``load_exported`` imports the
three modules so the ops are registered before the archive is read. The artifact holds the weights on
the device it was exported on, and serves there.

The JAX package's artifact (StableHLO from ``jax.export``) and this one
cannot be read across the two packages; each serves its own.

    python -m css_tpu_torch.cli.export --checkpoint ckpt.mdl \\
        --model Conformer --output fwd.pt2 [--device cuda]
"""

from __future__ import annotations

import argparse
from pathlib import Path

import torch

from css_tpu_torch.device import resolve_device
from css_tpu_torch.executor.windowing import EXTRA_SAMPLES
from css_tpu_torch.executor.separator import require_masks
from css_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)


class MaskForward(torch.nn.Module):
    """The exported function: features (B, T, F) -> masks clamped at 1."""

    def __init__(self, model: torch.nn.Module):
        super().__init__()
        self.model = model

    def forward(self, f: torch.Tensor) -> torch.Tensor:
        out = self.model(f)
        masks = out[1] if isinstance(out, tuple) else out
        return torch.clamp(masks, max=1.0)


def export_forward(model: torch.nn.Module, batch_size: int, num_frames: int,
                   feature_dim: int, device="cuda"):
    """``torch.export`` of ``model``'s eval-mode masks at a fixed float32
    (batch_size, num_frames, feature_dim) on ``device`` -> the
    ExportedProgram (save it with ``torch.export.save``). The model is
    moved to ``device`` and put in eval mode."""
    require_masks(model, "the exported forward")
    dev = resolve_device(device)
    model = model.to(dev).eval()
    example = torch.zeros((batch_size, num_frames, feature_dim),
                          dtype=torch.float32, device=dev)
    with torch.no_grad():
        return torch.export.export(MaskForward(model), (example,))


def input_shape(program) -> tuple:
    """An ExportedProgram's fixed input shape (B, T, F)."""
    node = next(n for n in program.graph.nodes if n.op == "placeholder"
                and n.name in program.graph_signature.user_inputs)
    return tuple(int(d) for d in node.meta["val"].shape)


def load_exported(path: str):
    """A ``.pt2`` artifact -> a callable module f (B, T, F) -> masks, with
    ``input_shape`` (B, T, F), the shape it was exported at."""
    # register the port's ops (K2, KC, KN) before the archive is read
    from css_tpu_torch.ops import (add_layer_norm_cuda,  # noqa: F401
                                   conv_module_cuda, lstm_cuda)

    program = torch.export.load(str(path))
    module = program.module()
    module.input_shape = input_shape(program)
    return module


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("--model", required=True)
    parser.add_argument("--output", required=True)
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("--eval-win", type=float, default=2.4)
    parser.add_argument("--frame-length", type=int, default=512)
    parser.add_argument("--frame-shift", type=int, default=256)
    parser.add_argument("--extra-samples", type=int, default=EXTRA_SAMPLES,
                        help="samples added to a window (the separator's "
                             "fixed 256)")
    parser.add_argument("--sr", type=int, default=16000)
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu: where the artifact's "
                             "weights live and where it serves")
    args = parser.parse_args(argv)
    if args.extra_samples != EXTRA_SAMPLES:
        raise SystemExit(f"--extra-samples: the port's separator adds "
                         f"{EXTRA_SAMPLES} samples to a window")

    from css_tpu_torch.cli.separate import load_model
    from css_tpu_torch.trainer.checkpoint import load_checkpoint

    conf = dict(load_checkpoint(args.checkpoint).get("conf", {}))
    model = load_model(args.checkpoint, args.model)
    win = int(args.eval_win * args.sr) + EXTRA_SAMPLES
    frames = (win - args.frame_length) // args.frame_shift + 1
    idim = int(conf.get("idim", 257))
    program = export_forward(model, args.batch_size, frames, idim,
                             args.device)
    torch.export.save(program, args.output)
    log.info("Exported %s forward (%d x %d x %d) -> %s (%d bytes)",
             args.model, args.batch_size, frames, idim, args.output,
             Path(args.output).stat().st_size)


if __name__ == "__main__":
    main()
