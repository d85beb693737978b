#!/usr/bin/env bash
# LibriCSS continuous separation on the PyTorch/CUDA port (css_tpu_torch):
# prepare -> separate -> wer, the counterpart of separate_libricss.sh.
#
#   device=cuda bash recipes/separate_libricss_torch.sh <corpus_dir> \
#       <checkpoint> [outdir]
#
# Environment: config (default configs/infer_1ch.yaml), model (Conformer),
# device (cuda; cpu on a machine without a card), SESSIONS (the session
# names to separate, one process each, all on the one device), ASR_CMD
# (a command template with {wav}, e.g. 'python -m css_tpu_torch.cli.toy_asr
# {wav}' on the synthetic corpus: scores WER into <outdir>/wer.jsonl).
# Each stage's seconds are printed as "stage <name>: <s> s". A failed
# separation fails the recipe.
set -euo pipefail

corpus_dir=${1:?usage: separate_libricss_torch.sh <corpus_dir> <checkpoint> [outdir]}
checkpoint=${2:?}
outdir=${3:-exp/separated_torch}
config=${config:-configs/infer_1ch.yaml}
model=${model:-Conformer}
device=${device:-cuda}
SESSIONS=${SESSIONS:-session0 session1 session2 session3 session4 session5 session6 session7 session8 session9}

stage_done() {  # name, start time
  awk -v a="$2" -v b="$EPOCHREALTIME" -v n="$1" \
    'BEGIN { printf "stage %s: %.3f s\n", n, b - a }'
}

# The LibriCSS release layout gets a session manifest and the WER
# references; any other tree is walked by cli.separate's --corpus-dir.
mkdir -p "$outdir"
input_args=(--corpus-dir "$corpus_dir")
t=$EPOCHREALTIME
if compgen -G "$corpus_dir/*/*/record/raw_recording.wav" > /dev/null; then
  python -m css_tpu_torch.cli.prepare libricss --corpus-dir "$corpus_dir" \
    --output "$outdir/recordings.jsonl" \
    --transcripts-output "$outdir/refs.jsonl"
  input_args=(--manifest "$outdir/recordings.jsonl")
fi
stage_done prepare "$t"

t=$EPOCHREALTIME
pids=()
for session in $SESSIONS; do
  python -m css_tpu_torch.cli.separate \
    --config "$config" \
    --checkpoint "$checkpoint" \
    --model "$model" \
    "${input_args[@]}" \
    --out-dir "$outdir" \
    --session "$session" \
    --device "$device" &
  pids+=($!)
done
for pid in "${pids[@]}"; do
  wait "$pid"
done
stage_done separate "$t"

if [[ -n "${ASR_CMD:-}" && -f "$outdir/refs.jsonl" ]]; then
  t=$EPOCHREALTIME
  python -m css_tpu_torch.cli.wer --estimates "$outdir" \
    --references "$outdir/refs.jsonl" --asr-cmd "$ASR_CMD" \
    --output "$outdir/wer.jsonl"
  stage_done wer "$t"
fi
