#!/usr/bin/env bash
# The synthetic quality recipe of recipes/train_quality.sh on the
# PyTorch/CUDA port (css_tpu_torch.cli.train), with the same phases and
# hyperparameters:
#
#   base     Conformer-large on the dense-f0 synthetic corpus (96 speakers,
#            f0 up to 400 Hz), mixed on the card (--device-mix)
#   decay    fast-decay continuation from a late base checkpoint (INIT=)
#   masksnr  MaskSNR fine-tuning from a late checkpoint (INIT=), with the
#            probe's top-2 average written as avgtop.1.mdl
#
#   device=cuda bash recipes/train_quality_torch.sh <phase> [expdir]
#
# VOICE=formant switches the corpus to the formant voice model. The held-
# out evaluation phase of train_quality.sh runs scripts/quality_eval.py,
# a tool of the JAX package that the port does not have; the checkpoints
# written here are in the npz format that tool reads.
set -euo pipefail

phase=${1:-base}
expdir=${2:-exp/quality_torch}
VOICE=${VOICE:-harmonic}
INIT=${INIT:-}
device=${device:-cuda}

objective=MSE
[ "$phase" = masksnr ] && objective=MaskSNR
common=(--model Conformer --objective "$objective"
        --synthetic-data --synthetic-speakers 96 --synthetic-utts 12
        --synthetic-f0-max 400 --synthetic-voice "$VOICE"
        --batch-size 32 --optim adam --weight-decay 0.01 --grad-thresh 5.0
        --keep-best --validate-batches 16 --probe-sessions 4
        --device-mix --bf16 --steps-per-dispatch 16 --num-workers 2 --job 1
        --device "$device")

case "$phase" in
  base)
    python -m css_tpu_torch.cli.train --expdir "$expdir" "${common[@]}" \
      --num-epochs 100 --batches-per-epoch 512 \
      --lr 1e-4 --warmup 20000 --decay 1e-5 --mse-noise-weight 0.3 \
      --keep-every 10 --keep-last 3
    ;;
  decay)
    : "${INIT:?decay needs INIT=<base checkpoint .mdl>}"
    python -m css_tpu_torch.cli.train --expdir "$expdir" "${common[@]}" \
      --num-epochs 20 --batches-per-epoch 512 \
      --lr 7e-5 --warmup 100 --decay 2e-4 --mse-noise-weight 0.3 \
      --keep-every 5 --keep-last 5 --init "$INIT" --seed 7
    ;;
  masksnr)
    : "${INIT:?masksnr needs INIT=<pretrained checkpoint .mdl>}"
    python -m css_tpu_torch.cli.train --expdir "$expdir" "${common[@]}" \
      --num-epochs 15 --batches-per-epoch 512 \
      --lr 2e-5 --warmup 100 --decay 1e-4 \
      --masksnr-mag-weight 0.05 --average-probe-top 2 \
      --keep-every 3 --keep-last 5 --init "$INIT" --seed 11
    ;;
  eval)
    echo "eval: the held-out protocol is scripts/quality_eval.py of the JAX" \
         "package (not ported); run it on these checkpoints" >&2
    exit 2
    ;;
  *)
    echo "unknown phase: $phase (base|decay|masksnr|eval)" >&2; exit 2
    ;;
esac
