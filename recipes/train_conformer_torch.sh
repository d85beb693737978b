#!/usr/bin/env bash
# Conformer-large CSS training on the PyTorch/CUDA port (css_tpu_torch):
# the hyperparameters of recipes/train_conformer.sh (adam, lr 1e-4, warmup
# 20000, decay 1e-5, wd 1e-2, clip 5.0, MSE with noise weight 0.3, bf16,
# 500 batches/epoch, 100 epochs; throughput mode: batch 64 on windows
# aligned to 128 frames, or parity=1 for batch 32 unaligned).
#
#   bash recipes/train_conformer_torch.sh [expdir] [train_manifest] [extra]
#
# strategy (default dp) picks the route:
#   dp | replica_avg  one process per card on this host
#                     (css_tpu_torch.parallel.launch; nproc cards,
#                     default: every card nvidia-smi lists)
#   single            one process, one card (css_tpu_torch.cli.train)
#   jobs              the per-epoch job driver: independent jobs ramping
#                     from nj_init to nj_final, averaged every epoch
#                     (css_tpu_torch.cli.train_parallel)
# device (default cuda; cpu runs the same code on the CPU).
set -euo pipefail

expdir=${1:-exp/conformer_large_torch}
train_manifest=${2:-}   # jsonl from `python -m css_tpu_torch.cli.prepare utterances`
shift $(( $# < 2 ? $# : 2 ))
strategy=${strategy:-dp}
device=${device:-cuda}

data_args=(--synthetic-data --synthetic-rirs)
if [[ -n "$train_manifest" ]]; then
  data_args=(--train-manifest "$train_manifest")
fi

speed_args=(--batch-size 64 --align-window-frames 128)
if [[ "${parity:-0}" = 1 ]]; then
  speed_args=(--batch-size 32)
fi

train_args=(
  "${data_args[@]}"
  "${speed_args[@]}"
  --model Conformer --objective MSE
  --batches-per-epoch 500
  --optim adam --lr 1e-4 --weight-decay 1e-2 --grad-thresh 5.0
  --warmup 20000 --decay 1e-5
  --mse-noise-weight 0.3
  --bf16
  --keep-every 20 --keep-last 2
  --device "$device"
)

case "$strategy" in
  dp|replica_avg)
    nproc=${nproc:-$({ nvidia-smi -L 2>/dev/null || true; } | wc -l)}
    (( nproc >= 1 )) || nproc=1
    python -m css_tpu_torch.parallel.launch --num-processes "$nproc" -- \
      --expdir "$expdir" --num-epochs 100 --strategy "$strategy" \
      "${train_args[@]}" "$@"
    ;;
  single)
    python -m css_tpu_torch.cli.train --expdir "$expdir" --num-epochs 100 \
      "${train_args[@]}" "$@"
    ;;
  jobs)
    python -m css_tpu_torch.cli.train_parallel --expdir "$expdir" \
      --num-epochs 100 --nj-init "${nj_init:-1}" --nj-final "${nj_final:-4}" \
      --keep-every 20 --keep-last 2 -- "${train_args[@]}" "$@"
    ;;
  *)
    echo "unknown strategy: $strategy (dp|replica_avg|single|jobs)" >&2
    exit 2
    ;;
esac
