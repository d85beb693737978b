#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (css_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each timed on its own line:
  1. device: the card, its name and power limit (nvidia-smi), and the
     build of every CUDA kernel from ``css_tpu_torch/csrc`` (nvcc, cold).
  2. kernels: each kernel against its plain PyTorch version on the card,
     with TF32 off, at the main paths' shapes (K1 also through its
     centered entry, at the 7ch path's shape); kernel, plain and library
     times (CUDA events, median of 30 after 3 warm-ups), and each kernel's
     device time without host overhead (torch.profiler). K2 (the LSTM
     recurrence) in float32 and bf16, forward and reverse, at the BLSTM's
     hidden 512 and the causal BLSTM's hidden 1024, each comparison
     launching its kernel exactly once and taking no plain route, and in
     float32 held also to a tight bound that a single-TF32 product of the
     same function (the plain version with TF32 on) must fail, as a
     control; then K2's phase split
     at the main shape in float32 and bf16 (mean clock64() cycles per step
     of barrier wait, staging of h_{t-1}, product, and gates with the
     rest, from the kernel's optional phase record).
  3. Conformer path: the committed flagship checkpoint through
     ``CssPipeline.process`` on a 60 s synthetic 2-talker session, with
     launch counts and plain-route counts reset before and read after
     each run (a kernel run must launch every kernel of its path and take
     no plain route):
       (a) the flagship's own bf16 compute, with the kernels;
       (b) float32 compute (TF32 off), with the kernels;
       (p) float32 compute on the plain versions (no kernel launch);
     (b) must match (p), and (a) must match (b) above an SI-SNR floor
     and a worst-segment SNR floor, which two stream-swapped copies of
     (b) must fail.
     Then stream re-anchoring (``executor/reanchor.py``) once on (b)'s
     streams: its swap count and host seconds.
  4. BLSTM path: a full-width BLSTM (hidden 1024, 3 layers) with random
     weights from a numpy seed through ``CssPipeline.process`` on the same
     session: float32 with the kernels, float32 on the plain versions, and
     bf16 with the kernels; the float32 runs must match on masks and
     streams, and bf16 must stay near float32 on the masks.
  5. Conformer 7ch path: the committed 7ch checkpoint at full width and
     depth under ``configs/infer_7ch.yaml`` (IPD features, DOA merge,
     Souden MVDR) on the same two voices placed at two azimuths 120
     degrees apart on the 7-mic array, with 0.003 sensor noise; runs (a),
     (b) and (p) as on the Conformer path, with the same gates, and equal
     DOA-merge kill counts in (b) and (p). The checkpoint must separate
     the session: SI-SNRi of (b) against the sources at least
     SI_SNRI_7CH_DB, and the merge may kill at most MAX_KILL_SHARE of the
     windows. Printed: the stage seconds, the kill count, SI-SNRi, and the
     card times of the beamformer's calls one by one (the centered STFT,
     the SCM products, the batched 7x7 solves, apply, dedup, K1's centered
     entry) and of the DOA projections.
  6. Conformer train path: training at the flagship's full width (16 x
     256, 4 heads, kernel 33, 257 bins, 2 speakers + noise) on the
     recipe's on-the-fly mixtures (``SyntheticCorpus`` with synthetic RIRs
     and noise), with K3 featurizing every step (one launch over the
     stacked mix and sources). First K3 at the training shape against its
     plain version, with its times and bound. Then:
       (a) kernel vs plain, float32: one step's loss, pre-clip gradient
           norm and gradients from one state and batch, featurized by K3
           and by the plain version (gates TRAIN_*), with a control batch
           whose gradient must fail the gradient gate;
       (b) descent, bf16: DESCENT_STEPS Adam steps at DESCENT_LR on one
           fixed batch from random weights must lower the loss by at least
           DESCENT_MIN_DROP, which the same steps at lr 0 must not;
       (c) the recipe's run through ``cli.train``'s own code (bf16, a few
           epochs of a few batches, warm-started from the flagship, launch
           counts reset before and read after: K3 once per train and
           validation batch, no plain route):
           finite losses, the checkpoints and jsonl written, the trained
           checkpoint through the 1ch separation of the session (finite
           streams, peak 0.9), and reloading it gives the trainer's
           tensors bit for bit;
       (d) a batch with a NaN leaves params, Adam's state and the
           BatchNorm statistics bit-equal and advances the step counter;
       (e) Conv-TasNet at its default width (512 filters, 8 x 3 blocks), a
           few float32 SI-SNR steps: finite losses, step ms.
     Printed: the median warm train-step ms and train audio-sec/s (batch x
     window seconds / step seconds) in bf16 and float32 for the Conformer
     and a full-width BLSTM (hidden 1024, 3 layers).
  7. Conformer 7ch train path: the committed 7ch checkpoint at full width
     and depth (1799 inputs: channel 0's magnitude and 6 IPD pairs) on
     batches of 32 x 4.0 s rendered on the 7-mic array (``SpatialMixer``
     over the CLI's default corpus, sensor noise 0.003), K3 featurizing
     channel 0 and the sources in one launch a step. First K3 at that
     shape against its plain version, with its times and bound. Then:
       (a) kernel vs plain, float32: one step of the 7ch model, the train
           path's gates and control batch;
       (b) device against host mixing of the same recipes (the 1ch mixer
           with RIRs and noise; the spatial mixer at sensor noise 0): the
           sources bit-equal, the mixtures within MIX_ATOL; with sensor
           noise on, its standard deviation within NOISE_STD_RTOL of the
           level and one recipe materialised twice bit-equal;
       (c) the 7ch recipe through ``cli.train`` (--spatialize-channels 7
           --device-mix --probe-sessions 2 --average-probe-top 2, 3 epochs
           of 2 batches, warm-started from the 7ch checkpoint, launch
           counts reset before and read after: K3 once per train and
           validation batch and per probe call, K1 once per probe call, no
           plain route): finite losses and probes, avgtop.1.mdl written,
           and the last checkpoint reloads bit-equal;
       (d) the held-out probe of the flagship in float32 within
           PROBE_ATOL_DB of css_tpu's value on the CPU, one K3 and one K1
           launch a call, and the 7ch checkpoint's spatial probe; K3 over
           the probe's windows and K1 over its resynthesis rows against
           their plain versions, with times and bounds;
       (e) the native mixing core (built by g++ in phase 1): the mixer's
           native path against the numpy path, and no fall-back to numpy
           in the whole run.
     Printed: the 7ch train step's median ms in bf16 and float32 on
     host-mixed and on device-mixed batches, and the probe's seconds per
     call, each beside the card's name and power limit.
  8. Streaming: the session pushed in PUSH_SEC pieces, launch and
     plain-route counts reset before and read after each streaming run.
       (a) window mode (``StreamingCssPipeline``), the flagship at full
           width and depth: float32 with the kernels against
           ``CssPipeline.process`` (after peak normalisation) and against
           the same run on the plain versions; bf16 against float32 under
           phase 3's gates and swap controls; K3 and K1 once per window;
           the retained audio and masks bounded; the per-push wall time
           (median, p90) and the emitted audio's lag;
       (b) window mode, the 7ch checkpoint on phase 5's session: against
           ``CssPipeline.process``; K3 and K1's centered entry once per
           window;
       (c) hop mode (``HopStreamingPipeline``), a causal BLSTM at hidden
           1024 x 3 layers from a numpy seed, HOP_CHUNK frames a chunk: K2
           with a carried state against its plain version (tight float32
           bound, single-TF32 control), K2 chained over chunks against one
           launch, the chained stream masks against the offline causal
           forward, push-size invariance, K2 three times a chunk, bf16
           finite; the per-chunk wall time;
       (d) hop mode, the flagship's weights in a causal Conformer (left
           context 128): chained stream masks (one chunk longer than the
           left context) against the causal forward, push-size invariance,
           the per-chunk wall time.
     K3, K1 and K2 at the streaming shapes against their plain versions,
     with their times and bounds (the kernels line's ``stream`` entries).
  9. Parallel (one card: ranks share it over gloo, or one runs alone over
     NCCL; correctness and overhead, not scaling), each rank a process
     of the port's own entry points, writing its launch and plain-route
     counts and its results to files this script reads:
       (a) DP at world 1 (NCCL) against the same steps under the single
           strategy, from the flagship's weights, 32 x 4.0 s, float32;
       (b) DP at world 2, 16 rows a rank, against single on all 32: loss,
           gradients, BatchNorm statistics, parameters after 3 Adam steps;
           per-rank BatchNorm statistics, the control, must fail;
       (c) TP = 2, one step against single, gradients gathered;
       (d) replica averaging at world 2 against the replicas' own runs;
       (e) ``python -m css_tpu_torch.parallel.launch --num-processes 2 --
           --strategy dp --device-mix ...`` (bf16): rank 0 alone writes,
           bit-equal ranks, K3 once a batch on each rank;
       (f) ``cli.train_parallel`` with a crashing job, elastic and abort;
       (g) ``CssPipeline`` with ``sharded: true`` over [cuda:0, cuda:0]
           on the session, flagship and full-width BLSTM, against the
           unsharded pipeline; K3 once a shard batch, K1 once, K2 on the
           BLSTM's shard batches.
     The PAR_* comments hold the gates.
 10. Export, serve, import, tools (the CLIs the JAX package has beside
     separation and training):
       (a) ``cli.export``'s ``export_forward`` (torch.export) of the
           flagship (its bf16 compute) and of the full-width BLSTM (float32)
           at the separator batch (32, 150, 257), saved and loaded: seconds
           and bytes; the BLSTM's graph holds K2 as 6 registered-op nodes
           and no unrolled loop, the Conformer's no op of the port's;
       (b) ``Separator(None, exported_path=...)`` in the pipeline against
           the live separator on the session: masks (and the BLSTM's
           magnitudes) within SERVE_*_ATOL, each served run launching what
           the live one launches (K3 3, K1 1, K2 18 on the BLSTM), no plain
           route; served and live seconds per session (median of
           SERVE_REPS);
       (c) the flagship's weights saved as a reference torch ``.mdl`` and
           imported by ``python -m css_tpu_torch.cli.import_torch``: the
           imported checkpoint's float32 masks against the flagship's;
       (d) ``recipes/separate_libricss_torch.sh`` with the flagship on a
           LibriCSS-layout tree of synthetic sessions (prepare ->
           ``cli.separate --config configs/infer_1ch.yaml`` -> ``cli.wer``
           with ``cli.toy_asr`` as the ASR): exit 0, per-stage seconds, a
           finite corpus WER, each separation's logged launches (K3 and K1,
           no plain route); then ``cli.evaluate`` on the streams against
           an in-process SI-SNR of the same files.
Then one JSON line of per-kernel numbers, the card's name and power limit,
and last the result line ``{"ok": true, "device": {...}}``. Progress goes
to stderr. Any failed check raises, and the exit code is then non-zero;
without a CUDA device the script exits 1 and prints no result.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

# configs/infer_1ch.yaml, as a dict (the port does not depend on PyYAML);
# tests/test_torch_imports.py holds the two equal
CONFIG = {
    "sampling_rate": 16000,
    "separation": {"batch_size": 32, "eval_hop": 0.8, "eval_win": 2.4,
                   "frame_length": 512, "frame_shift": 256},
    "stitching": {"eval_hop": 0.8, "eval_win": 2.4, "hop_size": 256,
                  "n_fft": 512},
    "beamforming": {"batch_size": 32, "type": "masking", "hop_size": 256,
                    "n_fft": 512, "eval_hop": 0.8, "proceed_margin": 2,
                    "eval_win": 2.4, "wta_thresh": 0.0001},
}
CHECKPOINT = "checkpoints/h2ft_masksnr_best.mdl"
SESSION_SEC = 60.0
SEED = 20261017
# configs/infer_7ch.yaml, as a dict; tests/test_torch_imports.py holds the
# two equal
CONFIG_7CH = {
    "sampling_rate": 16000,
    "separation": {"batch_size": 32, "eval_hop": 0.8, "eval_win": 2.4,
                   "frame_length": 512, "frame_shift": 256,
                   "ipd": "1,0;2,0;3,0;4,0;5,0;6,0", "merge": True,
                   "merge_threshold": 16},
    "stitching": {"eval_hop": 0.8, "eval_win": 2.4, "hop_size": 256,
                  "n_fft": 512},
    "beamforming": {"batch_size": 32, "type": "SoudenMVDRBeamformer",
                    "hop_size": 256, "n_fft": 512, "eval_hop": 0.8,
                    "proceed_margin": 2, "eval_win": 2.4,
                    "wta_thresh": 0.0001},
}
CHECKPOINT_7CH = "checkpoints/s7_mse_best.mdl"
# the two voices' azimuths on the 7-mic array, and the sensor noise (the
# 7ch checkpoint's training sensor noise level). The checkpoint separates
# these voices at 90/210 degrees (+13.1 dB SI-SNRi in float32 on the CPU)
# but not with a voice near 30 degrees (-10.8 dB at 30/150).
AZIMUTHS_7CH = (90.0, 210.0)
SENSOR_NOISE = 0.003
# the 7ch path's separation gates on (b): SI-SNRi of the float32 streams
# against the voices at channel 0, and the share of windows whose weaker
# stream the DOA merge may kill (a window with one voice is killed by
# design; 13 of 73 on the CPU)
SI_SNRI_7CH_DB = 6.0
MAX_KILL_SHARE = 0.35

# H100 SXM data sheet: FP32 on the CUDA cores (K1 and K3 run FP32 FMAs),
# dense TF32 and bf16 on the tensor cores, and HBM3 bandwidth. Rates at
# the full 700 W power limit. K2 runs its float32 product on the tensor
# cores as 3xTF32, three TF32 products for each float32 one, so its
# float32 bound is taken at a third of the TF32 rate (165 TFLOP/s), the
# fastest way to a float32-accurate product on this card; the bound at
# the CUDA cores' FP32 rate is printed beside it.
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_3XTF32_FLOPS = PEAK_TF32_FLOPS / 3
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12

# Kernel vs plain on the same card, float32, TF32 off: the two sum the
# same products in another order (tests/test_istft_pallas.py uses the
# same tolerance for the TPU kernel against its XLA reference).
KERNEL_ATOL, KERNEL_RTOL = 2e-4, 1e-4
# Pipeline (b) vs (p): the feature magnitudes differ by ~1e-6 relative,
# which moves the float32 masks and the peak-normalised (0.9) output by
# far less than one 16-bit PCM step (3e-5); 1e-3 leaves room for a
# winner-take-all bin whose two masks tie within that noise.
PIPE_ATOL = 1e-3
# (a) vs (b): bf16 keeps 8 mantissa bits, so over 16 blocks the masks move
# by ~1e-2; the winner-take-all then flips the few bins where two streams'
# masks nearly tie. Two gates, each read under the better of the two global
# stream orders: the SI-SNR of the whole session, and the lowest SNR of any
# 4 s segment, which a stream-order flip at one late stitch boundary cannot
# pass although it leaves the whole-session figure high. Two controls made
# from (b) itself, its streams swapped from the middle boundary and from
# the last one, must fail the gates, so a blind gate fails the run.
BF16_SI_SNR_DB = 15.0
BF16_SEGMENT_SEC = 4.0
BF16_SEGMENT_SNR_DB = 10.0
# K2 in bf16 against its plain version: both round h to bf16 every step,
# so a value near a rounding boundary can land one bf16 step (up to 2^-8
# on |h| < 1) the other way and carry into later steps; 3e-2 allows about
# 8 such steps (tests/test_torch_cuda.py holds the same bound).
LSTM_BF16_ATOL = 3e-2
# K2 in float32 against its plain version, a second and tight bound beside
# KERNEL_ATOL/RTOL: its 3xTF32 product keeps ~21 of float32's 24 bits,
# while a single TF32 product keeps 11. On an H100 the kernel's max abs
# error on h here is ~1.8e-7 and the single-TF32 control's 5e-5 to 7e-5;
# 5e-6 lies between. The control, the plain version with its product in
# single TF32 (torch's TF32 matmul) on the same inputs, must fail it, so a
# kernel that rounded its operands to TF32 alone would fail the run.
LSTM_F32_MAX_ERR = 5e-6
# The BLSTM path: a full-width BLSTM (the JAX package's build_model
# defaults: hidden 1024, i.e. 512 per direction, 3 layers) with random
# weights from BLSTM_SEED, on the same session. Random weights make an
# SI-SNR gate meaningless, so the gates are on masks and streams:
#  * float32 kernels vs plain, the separator's masks (clamped at 1):
#    the two sum the LSTM products in another order, ~1e-6 per step,
#    carried through 3 layers and 150 steps: 1e-3 absolute; the streams:
#    PIPE_ATOL, as for the Conformer.
#  * bf16 vs float32 masks: bf16 keeps 8 mantissa bits in the input
#    projections, h and the mask head, so the masks move by about 2^-8
#    relative per rounding; at hidden 256 and 512 on the CPU the two
#    differed by max 0.031 and mean 1.8e-3 on masks in [0, 1]: 0.1 max
#    and 1e-2 mean absolute, the bounds tests/test_torch_blstm.py holds
#    for bf16.
BLSTM_SEED = 20261018
BLSTM_MASK_ATOL = 1e-3
BLSTM_BF16_MAX, BLSTM_BF16_MEAN = 0.1, 1e-2
# The train path: the recipe's batch of 32 (recipes/train_conformer.sh with
# parity=1) at its largest window bucket, 4.0 s (249 frames), mixed on the
# fly from the CLI's default synthetic corpus with its RIR and noise pools;
# weights from TRAIN_SEED; the recipe's optimiser (Adam, weight decay 1e-2,
# clip 5.0) and MSE with noise weight 0.3.
TRAIN_SEED = 20261019
TRAIN_BATCH, TRAIN_WINDOW_SEC = 32, 4.0
# (a) K3 vs the plain version in one float32 step. The loss and the
# pre-clip gradient norm are sums over the whole batch: 1e-5 and 1e-4
# relative. Single gradient elements are not gated: the model's per-bin
# MVN divides by a bin's standard deviation over time, which is ~1e-4 at
# the synthetic noise's spectral zeros (multiples of 2 kHz) in windows
# without added noise, so any two float32 STFTs (their magnitudes differ
# by ~1e-6 relative) move single gradient elements by up to ~10% of their
# tensor's largest (a CPU rehearsal with an FFT STFT in place of the
# matrix one: 4.6-13%). The gate is on the whole gradient: the norm of
# the difference over the norm, which that rehearsal put at 6.3e-4 (2
# blocks) and 1.5e-3 (6 blocks); 2e-2 leaves room for 16. The gradient of
# another batch, a control, must fail it.
TRAIN_LOSS_RTOL, TRAIN_NORM_RTOL, TRAIN_GRAD_L2 = 1e-5, 1e-4, 2e-2
# (b) The loss drop (1 - mean of the last 5 losses / the first) over 30
# steps at lr 1e-3 without warmup on one batch, bf16: a CPU rehearsal
# (recipe data, batch 4 / 8) gave 60% at 2 blocks and 43% at 6 blocks, the
# same steps at lr 0 1.5% and -0.4% (dropout noise only). 20% lies between.
DESCENT_STEPS, DESCENT_LR, DESCENT_MIN_DROP = 30, 1e-3, 0.2
# (c) the recipe's flags (recipes/train_conformer.sh, its throughput mode:
# batch 64 on windows aligned to 128 frames), cut to 2 epochs of 4 batches
# and 2 validation batches, warm-started (--init) from the flagship: from
# random weights the untrained model's winner-take-all can leave a stream
# silent, which the separation's peak check would read as a fault
RECIPE_ARGS = ["--synthetic-data", "--synthetic-rirs", "--batch-size", "64",
               "--align-window-frames", "128", "--model", "Conformer",
               "--objective", "MSE", "--optim", "adam", "--lr", "1e-4",
               "--weight-decay", "1e-2", "--grad-thresh", "5.0",
               "--warmup", "20000", "--decay", "1e-5",
               "--mse-noise-weight", "0.3", "--bf16", "--keep-every", "20",
               "--keep-last", "2"]
RECIPE_EPOCHS, RECIPE_BATCHES, RECIPE_VALID = 2, 4, 2
# The 7ch train path: the committed 7ch checkpoint at full width (1799
# inputs: channel 0's 257 bins and 6 IPD pairs) on batches of 32 x 4.0 s
# rendered on the 7-mic array (SpatialMixer over the CLI's default
# synthetic corpus, sensor noise SENSOR_NOISE); weights from the
# checkpoint, the recipe's optimiser and MSE objective. Gate (a) is the
# train path's (TRAIN_*).
TRAIN_7CH_SEED = 20261020
IPD_7CH = CONFIG_7CH["separation"]["ipd"]
# (b) device against host mixing of the same recipes: the sources are
# slices of the same utterances (bit-equal); the mixtures go through float32
# FFTs (reverb; the phase ramps and one irFFT) on the card and in numpy on
# the host. A CPU rehearsal at this shape (torch's CPU FFT against the
# host) gave 1.1e-7 on mixtures of peak ~0.3; 1e-5 leaves room for
# cuFFT's rounding. With sensor noise on, its standard deviation over the
# batch within NOISE_STD_RTOL of the level, and one recipe materialised
# twice bit-equal.
MIX_ATOL, NOISE_STD_RTOL = 1e-5, 0.05
# (c) the 7ch recipe through cli.train on the CLI's default corpus, 3
# epochs of 2 batches and 1 validation batch, device-mixed, with the probe
# on 2 sessions and the average of the 2 best-probed epochs, warm-started
# from the 7ch checkpoint
RECIPE_7CH_ARGS = [
    "--synthetic-data", "--spatialize-channels", "7",
    "--sensor-noise-level", str(SENSOR_NOISE), "--device-mix",
    "--probe-sessions", "2", "--average-probe-top", "2", "--model",
    "Conformer", "--objective", "MSE", "--optim", "adam", "--lr", "1e-4",
    "--weight-decay", "1e-2", "--grad-thresh", "5.0", "--warmup", "20000",
    "--decay", "1e-5", "--mse-noise-weight", "0.3", "--bf16",
    "--batch-size", str(TRAIN_BATCH), "--min-window-size", "4.0",
    "--max-window-size", "4.0", "--keep-best", "--keep-every", "20",
    "--keep-last", "2", "--num-workers", "2"]
RECIPE_7CH_EPOCHS, RECIPE_7CH_BATCHES, RECIPE_7CH_VALID = 3, 2, 1
# (d) the held-out probe of the flagship in float32, mask mode, on its own
# training run's probe material (the formant voice up to 400 Hz, 6
# speakers x 4 utterances, seed 456), 2 sessions of 12 s: css_tpu's
# HeldOutProbe gave +3.7355947494506836 dB on the CPU
# (scripts/torch_probe_reference.py; the port's on the CPU: +3.7321 dB).
PROBE_CORPUS = dict(num_speakers=6, utts_per_speaker=4, seed=456,
                    f0_max=400.0, voice="formant")
PROBE_SESSIONS, PROBE_SESSION_SEC = 2, 12.0
PROBE_REFERENCE_DB, PROBE_ATOL_DB = 3.7355947494506836, 0.1
# Phase 8, streaming. Window mode pushes the session in PUSH_SEC pieces.
# Its float32 streams, peak-normalised as the offline path normalises,
# must match CssPipeline.process on the card within STREAM_OFFLINE_ATOL,
# the bound of tests/test_streaming.py (the streaming mask average sums the
# same windows in another order); kernels against plain within PIPE_ATOL,
# bf16 against float32 under phase 3's gates. Its carried state stays
# within STREAM_BUFFER_WINDOWS windows of audio and of masks, as
# tests/test_streaming.py holds css_tpu's.
PUSH_SEC = 0.8
STREAM_OFFLINE_ATOL = 5e-3
STREAM_BUFFER_WINDOWS = 4
# Hop mode: a causal BLSTM at hidden 1024 x 3 layers (numpy-seeded
# weights; no causal checkpoint is committed) and the flagship's weights in
# a causal Conformer with left context 128, on HOP_SEC of the session in
# chunks of HOP_CHUNK frames. Chained stream masks against the offline
# causal forward within HOP_MASK_RTOL / HOP_MASK_ATOL and push-size
# invariance within HOP_PUSH_RTOL / HOP_PUSH_ATOL, the bounds of
# tests/test_hop_streaming.py. Without a trained causal model there is no
# quality gate: the gates are parity gates.
HOP_SEC, HOP_CHUNK, HOP_LEFT_CONTEXT = 20.0, 8, 128
HOP_SEED = 20261021
HOP_MASK_RTOL, HOP_MASK_ATOL = 2e-4, 2e-5
HOP_PUSH_RTOL, HOP_PUSH_ATOL = 1e-4, 1e-5
# K2 over HOP_CHAIN_CHUNKS chunks of HOP_CHUNK frames, chained through its
# returned state, against one launch over the whole sequence: the same
# float32 recurrence, expected bit for bit; held to LSTM_F32_MAX_ERR
HOP_CHAIN_CHUNKS = 18


# Phase 9, parallel. The script needs one card: ranks that share it
# run over gloo (NCCL refuses two ranks on one device), so these runs check
# collectives and numerics and measure overhead, not scaling. The model is
# the flagship (16 x 256, 4 heads, 1024 units, kernel 33, 257 bins, 2
# speakers + noise) from its committed weights, with dropout 0 (each rank's
# rows draw their own dropout, which a single process cannot replay), the
# recipe's optimiser and objective, float32 with TF32 off, on PAR_STEPS
# batches of 32 x 4.0 s of the train path's material. From random weights
# the order of a float32 sum alone moves this model's gradient by more than
# the gates (on an H100 a world-2 step lay 6.8e-4 rel-L2 from single;
# (c) prints its witness against single), and Adam turns that noise into
# steps of up to lr on the parameters whose true gradient is zero (the key
# bias, the depthwise conv's bias before BatchNorm, the conv module's
# output shift before the block's LayerNorm). So TP from random weights is
# held to a witness that sums in TP's order, in (c).
#   (a) DP at world 1 over NCCL against the same steps under --strategy
#       single: a world-1 all-reduce is an identity, so loss, gradients and
#       BatchNorm statistics within WORLD1_RTOL (relative). Step ms: the
#       median of PAR_TIMED_STEPS more steps, each run in a process of its
#       own (runner.py's ranks; single spawned as they are).
#   (b) DP at world 2 (16 rows a rank) against single on all 32: the JAX
#       package's tolerances (tests/test_parallel.py, tests/test_bn_dp.py,
#       tests/test_multihost.py): loss PAR_LOSS_RTOL, gradients rel-L2
#       PAR_GRAD_L2, BatchNorm statistics PAR_STATS_ATOL, parameters after
#       PAR_STEPS Adam steps PAR_PARAM_RTOL / PAR_PARAM_ATOL; the control,
#       per-rank BatchNorm statistics, must fail the gradient gate.
#   (c) TP = 2 (2 heads, 512 FFN units a rank): one step, the gates of (b)
#       on the gradients gathered to full shape; and from random weights
#       (TRAIN_SEED), the same gates against a witness, one process
#       computing each TP layer as the two ranks do and summing their
#       partial products in TP's order (runner.split_like_tp), with single
#       against that witness printed beside it.
#   (d) replica averaging at world 2: two replicas from their own draws
#       (TRAIN_SEED + j) on their own 16 rows, REPLICA_STEPS steps, each
#       held to a single-process run on its rows by the gates of (b); the
#       average over both within REPLICA_ATOL of the mean of the replicas'
#       own states, over replica 0 alone replica 0's state.
#   (e) the CLI through the launcher, the recipe's flags at 2 epochs of 2
#       batches, bf16, device-mixed: finite losses, rank 0 alone writes,
#       the ranks end bit-equal, K3 once a batch on each rank.
#   (f) cli.train_parallel, 2 epochs x 2 jobs of a small BLSTM, job 2 of
#       epoch 1 crashing (--inject-failure 1.2): elastic finishes from the
#       survivors, abort fails and leaves .error.1.2.
#   (g) sharded separation over [cuda:0, cuda:0] on the session (73
#       windows, padded to 74): the flagship and the full-width BLSTM in
#       float32 against the unsharded pipeline, masks SHARD_MASK_ATOL and
#       streams SHARD_STREAM_ATOL (tests/test_sharded_inference.py,
#       tests/test_pipeline_sharded.py).
PAR_CONF = {"conformer_dropout_rate": 0.0}  # build_model's defaults
PAR_STEPS, REPLICA_STEPS, PAR_TIMED_STEPS = 3, 2, 10
WORLD1_RTOL = 1e-6
PAR_LOSS_RTOL, PAR_GRAD_L2, PAR_STATS_ATOL = 1e-5, 1e-5, 1e-6
PAR_PARAM_RTOL, PAR_PARAM_ATOL = 1e-3, 1e-5
REPLICA_ATOL = 1e-6
SHARD_MASK_ATOL, SHARD_STREAM_ATOL = 1e-5, 1e-4
PAR_TIMEOUT_S = 300.0
PAR_CLI_EPOCHS, PAR_CLI_BATCHES, PAR_CLI_VALID = 2, 2, 1
PAR_CLI_ARGS = ["--synthetic-data", "--synthetic-rirs", "--batch-size",
                str(TRAIN_BATCH), "--min-window-size", "4.0",
                "--max-window-size", "4.0", "--model", "Conformer",
                "--objective", "MSE", "--optim", "adam", "--lr", "1e-4",
                "--weight-decay", "1e-2", "--grad-thresh", "5.0",
                "--warmup", "20000", "--decay", "1e-5",
                "--mse-noise-weight", "0.3", "--bf16", "--strategy", "dp",
                "--device-mix", "--num-epochs", str(PAR_CLI_EPOCHS),
                "--batches-per-epoch", str(PAR_CLI_BATCHES),
                "--validate-batches", str(PAR_CLI_VALID),
                "--dist-timeout", str(PAR_TIMEOUT_S)]
PARALLEL_SEED = 20261022
DRIVER_ARGS = ["--synthetic-data", "--synthetic-speakers", "4",
               "--synthetic-utts", "2", "--model", "BLSTM", "--objective",
               "MSE", "--batch-size", "4", "--batches-per-epoch", "3",
               "--optim", "adam", "--lr", "1e-3", "--blstm-hdim", "32",
               "--blstm-num-layers", "1", "--min-window-size", "2",
               "--max-window-size", "2", "--validate-batches", "1",
               "--num-workers", "1"]


# Phase 10, export, serve, import, tools. (b) The artifact of the
# full-width BLSTM (float32) runs the live model's ops, K2 through the
# registered op included, on the same inputs: masks and magnitudes within
# SERVE_BLSTM_ATOL. The flagship's artifact runs its bf16 compute's ops:
# expected bit-equal, held to SERVE_FLAGSHIP_ATOL (a bf16 rounding step of
# a mask near 1 is 2^-8; 1e-3 allows none), the gap printed. Each served
# run of the session launches what the live one launches. (c) The
# flagship's weights written as a reference torch checkpoint and imported
# by cli.import_torch: the imported checkpoint's float32 masks equal the
# flagship's within IMPORT_ATOL (the same float32 values). (d) The LibriCSS
# recipe on TOOLS_SESSIONS synthetic sessions of TOOLS_SESSION_SEC (pitch-
# token transcripts from PROBE_CORPUS's voices); cli.evaluate's SI-SNR of
# the separated streams against an in-process pit_si_snr_db of the same
# files within EVAL_ATOL_DB.
REPO_ROOT = os.path.dirname(os.path.abspath(__file__))
SERVE_BLSTM_ATOL = 1e-5
SERVE_FLAGSHIP_ATOL = 1e-3
SERVE_REPS = 5
IMPORT_ATOL = 1e-6
TOOLS_SESSIONS, TOOLS_SESSION_SEC = 2, 30.0
TOOLS_SEED = 20261023
EVAL_ATOL_DB = 1e-3
TOOLS_TIMEOUT_S = 600


def log(*args):
    print(*args, file=sys.stderr, flush=True)


def phase(name, t0):
    print(f"phase {name}: {time.perf_counter() - t0:.3f} s", flush=True)


def synthetic_session(sec: float, sr: int, seed: int):
    """A 2-talker conversation: formant-filtered harmonic voices with
    syllable envelopes, alternating turns with partial overlap, plus
    low noise. Returns (mix (T,), sources (2, T)) float32."""
    rng = np.random.default_rng(seed)
    n = int(sec * sr)
    srcs = np.zeros((2, n), np.float32)
    voices = [(110.0, (500.0, 1500.0, 2500.0)),
              (210.0, (750.0, 1900.0, 2900.0))]
    pos, turn = 0, 0
    while pos < n:
        f0, formants = voices[turn % 2]
        dur = int(rng.uniform(2.0, 5.0) * sr)
        t = np.arange(dur) / sr
        # slow pitch drift and syllable-rate (~4 Hz) amplitude envelope
        inst_f0 = f0 * (1.0 + 0.08 * np.sin(2 * np.pi * rng.uniform(0.2, 0.6)
                                             * t + rng.uniform(0, 6.3)))
        phase_ = 2 * np.pi * np.cumsum(inst_f0) / sr
        wav = np.zeros(dur)
        for h in range(1, int(4000 // f0)):
            fh = h * f0
            gain = sum(1.0 / (1.0 + ((fh - fc) / 120.0) ** 2) for fc in formants)
            wav += gain / h ** 0.5 * np.sin(h * phase_)
        env = np.clip(np.sin(2 * np.pi * rng.uniform(3.0, 5.0) * t
                             + rng.uniform(0, 6.3)), 0.0, None) ** 0.7
        wav *= env / (np.abs(wav).max() + 1e-9) * 0.3
        start = max(0, pos - int(rng.uniform(0.0, 0.3) * dur))
        end = min(n, start + dur)
        srcs[turn % 2, start:end] += wav[: end - start].astype(np.float32)
        pos, turn = start + dur, turn + 1
    mix = srcs.sum(axis=0) + 0.003 * rng.standard_normal(n).astype(np.float32)
    return mix.astype(np.float32), srcs


def si_snr_db(est: np.ndarray, ref: np.ndarray) -> float:
    est = est.astype(np.float64) - est.mean()
    ref = ref.astype(np.float64) - ref.mean()
    proj = (est @ ref) / max(ref @ ref, 1e-20) * ref
    noise = est - proj
    return float(10 * np.log10(max(proj @ proj, 1e-20)
                               / max(noise @ noise, 1e-20)))


def best_pair_si_snr(a, b) -> float:
    """Mean SI-SNR of a's streams against b's under the better of the two
    stream orders."""
    direct = np.mean([si_snr_db(a[0], b[0]), si_snr_db(a[1], b[1])])
    swapped = np.mean([si_snr_db(a[0], b[1]), si_snr_db(a[1], b[0])])
    return float(max(direct, swapped))


def worst_segment_snr(a, b, seg: int) -> float:
    """The lowest SNR of a's streams against b's over seg-sample segments,
    energy pooled over the streams, under the better global stream order."""
    direct = np.mean([si_snr_db(a[0], b[0]), si_snr_db(a[1], b[1])])
    swapped = np.mean([si_snr_db(a[0], b[1]), si_snr_db(a[1], b[0])])
    a = list(a) if direct >= swapped else [a[1], a[0]]
    worst = np.inf
    for lo in range(0, len(b[0]), seg):
        sig = sum(float(np.sum(np.square(r[lo:lo + seg], dtype=np.float64)))
                  for r in b)
        err = sum(float(np.sum(np.square(e[lo:lo + seg] - r[lo:lo + seg],
                                         dtype=np.float64)))
                  for e, r in zip(a, b))
        worst = min(worst, 10 * np.log10(max(sig, 1e-20) / max(err, 1e-20)))
    return float(worst)


def swapped_from(outs, start: int):
    """The two streams swapped from sample ``start`` on: what a wrong stream
    order from the stitch boundary there on would give."""
    return (np.concatenate([outs[0][:start], outs[1][start:]]),
            np.concatenate([outs[1][:start], outs[0][start:]]))


def time_ms(torch, fn, reps: int = 30, warmup: int = 3) -> float:
    """Median CUDA-event time of fn() in ms."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def device_ms(torch, fn, reps: int = 20):
    """Mean device time of one fn() call in ms: the sum of the CUDA kernels
    it runs, from torch.profiler's records over reps calls after a warm-up,
    without the host's launch overhead that an event pair around a short
    call also holds. None, with the reason logged, where the profiler saw
    no device activity or failed."""
    from torch.profiler import ProfilerActivity, profile

    try:
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total_us = sum(getattr(e, "self_device_time_total", None)
                       or getattr(e, "self_cuda_time_total", 0.0)
                       for e in prof.key_averages())
    except Exception as exc:  # noqa: BLE001 - a measurement, not a gate
        log(f"device_ms: torch.profiler failed: {exc!r}")
        return None
    if total_us <= 0:
        log("device_ms: torch.profiler recorded no device time")
        return None
    return total_us / reps / 1e3


def graph_ms(torch, fn, reps: int = 20):
    """Device ms of one fn() without the host's launch overhead, by a
    second route: reps calls captured in a CUDA graph, the graph replayed
    between two events (median of 10 replays) / reps. Back-to-back calls
    on the same inputs: an input and output that fit the 50 MB L2 stay
    there. None, with the reason logged, where capture fails."""
    try:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(3):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(reps):
                fn()
        graph.replay()
        torch.cuda.synchronize()
        times = []
        for _ in range(10):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            graph.replay()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / reps)
        del graph
        return float(np.median(times))
    except Exception as exc:  # noqa: BLE001 - a measurement, not a gate
        log(f"graph_ms: CUDA graph capture failed: {exc!r}")
        return None


def rfft_flops(n: int) -> float:
    """Operations of one length-n real FFT (or its inverse) by a radix-2
    algorithm: half of the complex FFT's 5 n log2 n."""
    return 2.5 * n * np.log2(n)


def bound_ms(flops: float, nbytes: float, peak: float = PEAK_FP32_FLOPS):
    """Least time for flops operations at ``peak`` (FP32 by default) and
    nbytes of device memory traffic, and which of the two bounds it."""
    t_ops = flops / peak
    t_bytes = nbytes / PEAK_HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def check_close(name, got, want, atol, rtol):
    err = float((got - want).abs().max())
    bad = (got - want).abs() > atol + rtol * want.abs()
    if bool(bad.any()) or not bool(got.isfinite().all()):
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version (max abs err {err:.3e})")
    return err


@contextlib.contextmanager
def plain_kernels(stft_mag_cuda, istft_cuda, lstm_cuda):
    """Route the main paths through the kernels' plain versions."""
    saved = stft_mag_cuda.stft_mag, istft_cuda.istft, lstm_cuda.lstm_fused
    stft_mag_cuda.stft_mag = stft_mag_cuda.stft_mag_plain
    istft_cuda.istft = istft_cuda.istft_plain
    lstm_cuda.lstm_fused = lstm_cuda.lstm_plain
    try:
        yield
    finally:
        (stft_mag_cuda.stft_mag, istft_cuda.istft,
         lstm_cuda.lstm_fused) = saved


def lstm_work(b: int, t: int, h: int, elem: int):
    """(operations, bytes) of one LSTM direction over precomputed input
    projections: the recurrent products (2*h*4h per row and step) and the
    cell update (4 gate adds, 3 for c, 1 for h; the 5 sigmoid/tanh
    evaluations are not counted); xw and W_hh read once, out written
    once."""
    flops = 2.0 * b * t * h * 4 * h + 8.0 * b * t * h
    nbytes = elem * (b * t * 4 * h + h * 4 * h + b * t * h)
    return flops, nbytes


def main_shapes() -> dict:
    """The main paths' kernel shapes under CONFIG: a separator batch of
    ``batch`` windows of ``win`` samples, ``n_frames`` frames each, and
    the ``n_windows`` windows that cover the session."""
    from css_tpu_torch.executor.windowing import EXTRA_SAMPLES

    sep = CONFIG["separation"]
    win = int(sep["eval_win"] * CONFIG["sampling_rate"]) + EXTRA_SAMPLES
    frame, hop = sep["frame_length"], sep["frame_shift"]
    return {"batch": sep["batch_size"], "win": win, "frame": frame,
            "hop": hop, "n_frames": (win - frame) // hop + 1,
            "n_windows": windows_of(SESSION_SEC)}


def windows_of(sec: float) -> int:
    """Separator windows that cover a recording of ``sec`` seconds under
    CONFIG."""
    from css_tpu_torch.executor.windowing import EXTRA_SAMPLES

    sep, sr = CONFIG["separation"], CONFIG["sampling_rate"]
    win = int(sep["eval_win"] * sr) + EXTRA_SAMPLES
    return -(-(int(sec * sr) - win) // int(sep["eval_hop"] * sr)) + 1


def stft_input(torch, dev):
    """K3's input on the main path: one separator batch of windows, here
    noise of standard deviation 0.1, from SEED."""
    m = main_shapes()
    x = np.random.default_rng(SEED).standard_normal((m["batch"], m["win"]))
    return torch.as_tensor((x * 0.1).astype(np.float32), device=dev)


def istft_input(torch, dev):
    """K1's input on the main path: every masked stream of the session, 2
    streams x n_windows windows, here the STFT of noise of standard
    deviation 0.1 times a mask uniform in [0, 1), from SEED + 1."""
    from css_tpu_torch.ops import stft as stft_ops

    m = main_shapes()
    rng = np.random.default_rng(SEED + 1)
    rows, bins = 2 * m["n_windows"], m["frame"] // 2 + 1
    sig = torch.as_tensor(rng.standard_normal((rows, m["win"]))
                          .astype(np.float32) * 0.1, device=dev)
    mask = torch.as_tensor(rng.uniform(0.0, 1.0, (rows, m["n_frames"], bins))
                           .astype(np.float32), device=dev)
    return (stft_ops.stft(sig, m["frame"], m["hop"]) * mask).contiguous()


def istft_centered_input(torch, dev):
    """K1's input on the 7ch path, through its centered entry: the
    beamformed spectra of the session, 2 streams x n_windows windows of
    n_frames + 2 centered frames, here the centered STFT of noise of
    standard deviation 0.1 times a mask uniform in [0, 1), from SEED + 2."""
    from css_tpu_torch.ops import stft as stft_ops

    m = main_shapes()
    rng = np.random.default_rng(SEED + 2)
    rows, bins = 2 * m["n_windows"], m["frame"] // 2 + 1
    sig = torch.as_tensor(rng.standard_normal((rows, m["win"]))
                          .astype(np.float32) * 0.1, device=dev)
    mask = torch.as_tensor(rng.uniform(0.0, 1.0, (rows, m["n_frames"] + 2,
                                                  bins)).astype(np.float32),
                           device=dev)
    return (stft_ops.stft(sig, m["frame"], m["hop"], center=True)
            * mask).contiguous()


def session_7ch(srcs):
    """The session's two voices placed at AZIMUTHS_7CH on the 7-mic array
    (exact fractional delays as rFFT phase ramps), plus SENSOR_NOISE white
    noise from SEED + 7: (7, T) float32. Channel 0 has no delay, so its
    images of the voices are the voices themselves."""
    from css_tpu_torch.data.spatial import spatialize

    return spatialize(srcs, AZIMUTHS_7CH, noise_level=SENSOR_NOISE,
                      rng=np.random.default_rng(SEED + 7))


def lstm_layer_inputs(torch, dev, hidden: int):
    """K2's inputs on one LSTM direction of a separator batch, at the
    BLSTM's hidden 512 a direction (input 1024) or the causal BLSTM's 1024,
    from SEED + hidden: xw = x @ W_ih^T + b with lecun-normal W_ih and
    orthogonal W_hh (the families of blstm.init_params) and x ~ N(0, 1), a
    LayerNorm output. Returns x, W_ih (4h, 1024), b (4h,), W_hh (h, 4h) and
    xw (B, T, 4h), float32."""
    from css_tpu_torch.models import blstm

    m = main_shapes()
    rng = np.random.default_rng(SEED + hidden)
    layer = blstm.init_params(SEED + hidden, {
        "blstm_hdim": 1024, "blstm_num_layers": 1,
        "blstm_causal": hidden == 1024})["encoders_0"]
    x = torch.as_tensor(rng.standard_normal((m["batch"], m["n_frames"], 1024))
                        .astype(np.float32), device=dev)
    w_ih = torch.as_tensor(layer["w_ih_fwd"], device=dev)
    bias = torch.as_tensor(rng.uniform(-0.2, 0.2, 4 * hidden)
                           .astype(np.float32), device=dev)
    w_hh = torch.as_tensor(np.ascontiguousarray(layer["w_hh_fwd"].T),
                           device=dev)
    return x, w_ih, bias, w_hh, x @ w_ih.t() + bias


def reference_state_dict(torch, params: dict, batch_stats: dict) -> dict:
    """The reference torch Conformer's state_dict (its names and layouts:
    ``conformer.encoders.i.conv.pw_conv_1`` a Conv2d(1, 2, 1), the
    depthwise conv (C, 1, K), Linear weights (out, in)) of a JAX-layout
    (params, batch_stats): the inverse of ``params_from_torch``, so that
    phase 10 can import the flagship as a reference checkpoint
    (tests/test_torch_import_torch.py holds it against css_tpu's
    converter)."""
    def t(a, shape=None):
        a = np.ascontiguousarray(np.asarray(a, np.float32))
        return torch.as_tensor(a if shape is None else a.reshape(shape))

    sd = {}

    def dense(name, p):
        sd[f"{name}.weight"], sd[f"{name}.bias"] = t(p["kernel"].T), t(
            p["bias"])

    def ln(name, p):
        sd[f"{name}.weight"], sd[f"{name}.bias"] = t(p["scale"]), t(p["bias"])

    conf = params["conformer"]
    dense("conformer.embed.0", conf["embed_linear"])
    ln("conformer.embed.1", conf["embed_norm"])
    sd["conformer.pos_emb.pe_k.weight"] = t(conf["pe_k"])
    blocks = sorted((k for k in conf if k.startswith("encoders_")),
                    key=lambda k: int(k.split("_")[1]))
    for k in blocks:
        p, e = f"conformer.encoders.{k.split('_')[1]}", conf[k]
        for ff in ("feed_forward_in", "feed_forward_out"):
            ln(f"{p}.{ff}.layer_norm", e[ff]["layer_norm"])
            dense(f"{p}.{ff}.net.0", e[ff]["w1"])
            dense(f"{p}.{ff}.net.3", e[ff]["w2"])
        ln(f"{p}.self_attn.layer_norm", e["self_attn"]["layer_norm"])
        for lin in ("linear_q", "linear_k", "linear_v", "linear_out"):
            dense(f"{p}.self_attn.{lin}", e["self_attn"][lin])
        c = e["conv"]
        ln(f"{p}.conv.layer_norm", c["layer_norm"])
        sd[f"{p}.conv.pw_conv_1.weight"] = t(c["pw1_w"], (2, 1, 1, 1))
        sd[f"{p}.conv.pw_conv_1.bias"] = t(c["pw1_b"])
        sd[f"{p}.conv.dw_conv_1d.weight"] = t(
            np.asarray(c["dw_kernel"]).transpose(2, 1, 0))
        sd[f"{p}.conv.dw_conv_1d.bias"] = t(c["dw_bias"])
        ln(f"{p}.conv.BN", c["bn"])
        stats = batch_stats["conformer"][k]["conv"]["bn"]
        sd[f"{p}.conv.BN.running_mean"] = t(stats["mean"])
        sd[f"{p}.conv.BN.running_var"] = t(stats["var"])
        sd[f"{p}.conv.pw_conv_2.weight"] = t(c["pw2_w"], (1, 1, 1, 1))
        sd[f"{p}.conv.pw_conv_2.bias"] = t(c["pw2_b"])
        ln(f"{p}.layer_norm", e["layer_norm"])
    dense("linear", params["linear"])
    return sd


def counted(kernel, n: int, label: str, fn):
    """fn(), which must launch ``kernel``'s wrapper n times and take no
    plain route; the counts are restored after, so that comparison
    launches never count toward a path's run."""
    saved = kernel.launches, kernel.plain_routes
    kernel.launches = kernel.plain_routes = 0
    try:
        out = fn()
        if kernel.launches != n or kernel.plain_routes != 0:
            raise AssertionError(
                f"{label}: {kernel.launches} launches and "
                f"{kernel.plain_routes} plain routes, expected {n} and 0")
    finally:
        kernel.launches, kernel.plain_routes = saved
    return out


def stage_seconds(torch, pipe, rec, dev, reps: int = 5):
    """Per-stage host seconds of a call, each stage ending in a
    synchronize: the median of each stage over reps warm calls, as one
    call's stage times move with the host clock's noise."""
    from css_tpu_torch.executor.windowing import pad_for_windows

    wav = torch.as_tensor(rec, device=dev)
    wav = pad_for_windows(wav, pipe.separator.win, pipe.separator.hop)
    samples = []
    for _ in range(reps):
        stages = {}
        torch.cuda.synchronize()
        clock = time.perf_counter()

        def mark(name):
            nonlocal clock
            torch.cuda.synchronize()
            now = time.perf_counter()
            stages[name] = now - clock
            clock = now

        masks, mags = pipe.separator.separate(wav)
        mark("separator")
        stitched = pipe.stitcher(masks, mags)
        mark("stitcher")
        outs = pipe.beamformer.continuous_process(wav, stitched)
        mark("beamformer")
        [o.cpu() for o in outs]
        mark("to_host")
        samples.append(stages)
    return {k: float(np.median([s[k] for s in samples])) for k in samples[0]}


def library_times(torch, pipe, rec, dev):
    """Card times (CUDA events, median of 30) of the library calls the
    7ch path makes, one by one, at its shapes on the session: the
    beamformer's centered STFT of all windows, the two SCM products, the
    batched 7x7 complex solves of all windows and streams, apply, the
    whole MVDR stage (these four plus the energy rescale), dedup and K1's
    centered entry; and the DOA projections of one separator batch. The
    spectra are the path's own; the separator's per-window masks stand in
    for the stitched ones (the same shapes)."""
    from css_tpu_torch.executor.windowing import pad_for_windows, unfold
    from css_tpu_torch.ops import istft_cuda, mvdr
    from css_tpu_torch.ops import stft as stft_ops

    wav = pad_for_windows(torch.as_tensor(rec, device=dev),
                          pipe.separator.win, pipe.separator.hop)
    masks, _ = pipe.separator.separate(wav)
    bf = pipe.beamformer
    windows = unfold(wav, bf.win, bf.hop)  # (B, 7, N)
    b = min(windows.shape[0], masks.shape[0])
    spec = stft_ops.stft(windows[:b], bf.n_fft, bf.hop_length,
                         center=True)[:, None]  # (B, 1, 7, T', F)
    t = spec.shape[-2]
    speech = bf._align_mask(masks[:b, :, :, :2].permute(0, 3, 1, 2), t)
    noise = bf._align_mask(masks[:b, None, :, :, 2], t)
    tgt = mvdr.compute_scm(spec, speech)
    noi = mvdr.compute_scm(spec, noise).expand_as(tgt).contiguous()
    w = mvdr.souden_coefficients(noi, tgt)
    speakers = masks[:b, ..., :2].permute(0, 3, 1, 2).contiguous()
    beams = bf._mvdr(windows[:b], speakers, masks[:b, ..., 2])
    ducked = bf._dedup(beams).reshape(-1, *beams.shape[2:]).contiguous()
    batch = pipe.separator.batch_size
    sep_spec = stft_ops.stft(unfold(wav, pipe.separator.win,
                                    pipe.separator.hop)[:batch],
                             bf.n_fft, bf.hop_length)  # (32, 7, T, F)
    sep_mask = (masks[:batch, ..., :2] > 0.5).float()
    steering = pipe.separator.steering
    out = {
        "stft_ms": time_ms(torch, lambda: stft_ops.stft(
            windows[:b], bf.n_fft, bf.hop_length, center=True)),
        "scm_shape": list(spec.shape[:1]) + [2] + list(spec.shape[2:]),
        "scm_ms": time_ms(torch, lambda: (mvdr.compute_scm(spec, speech),
                                          mvdr.compute_scm(spec, noise))),
        "solve_shape": list(tgt.shape),
        "solve_ms": time_ms(torch, lambda: torch.linalg.solve_ex(
            noi, tgt, check_errors=False)),
        "solve_and_trace_ms": time_ms(
            torch, lambda: mvdr.souden_coefficients(noi, tgt)),
        "apply_ms": time_ms(torch, lambda: mvdr.apply_beamformer(spec, w)),
        "mvdr_ms": time_ms(torch, lambda: bf._mvdr(
            windows[:b], speakers, masks[:b, ..., 2])),
        "dedup_ms": time_ms(torch, lambda: bf._dedup(beams)),
        "k1_centered_shape": list(ducked.shape),
        "k1_centered_ms": time_ms(torch, lambda: istft_cuda.istft_centered(
            ducked, bf.n_fft, bf.hop_length, length=windows.shape[-1])),
        "doa_shape": list(sep_spec.shape),
        "doa_likelihood_ms": time_ms(torch, lambda: steering.doa_likelihood(
            sep_spec, sep_mask)),
    }
    return out


def separator_masks(torch, pipe, mix, dev):
    """The separator's masks (windows, T, F, S) for the whole session."""
    from css_tpu_torch.executor.windowing import pad_for_windows

    wav = pad_for_windows(torch.as_tensor(mix, device=dev),
                          pipe.separator.win, pipe.separator.hop)
    return pipe.separator.separate(wav)[0]


@functools.lru_cache(maxsize=None)
def train_material():
    """The CLI's default synthetic corpus and its RIR and noise pools."""
    from css_tpu_torch.data.corpus import (SyntheticCorpus,
                                           synthetic_noise_pool,
                                           synthetic_rir_pool)

    return (SyntheticCorpus(seed=0, num_speakers=8, utts_per_speaker=6),
            synthetic_rir_pool(), synthetic_noise_pool())


def train_batch(seed: int, batch: int = None, window: float = None) -> dict:
    """One batch of the recipe's training material, mixed on the fly."""
    from css_tpu_torch.data.mixer import MixtureSynthesizer

    corpus, rirs, noises = train_material()
    window = window or TRAIN_WINDOW_SEC
    ds = MixtureSynthesizer.build_dataset(corpus, {
        "batch_size": batch or TRAIN_BATCH, "min_window_size": window,
        "max_window_size": window, "rir_pool": rirs, "noise_pool": noises,
        "seed": seed})
    return {k: v for k, v in next(ds).items() if k not in ("ovl", "lens")}


def make_trainer(torch, name: str, conf: dict, lr: float, dev,
                 objective: str = "MSE"):
    """A trainer with the recipe's optimiser on random weights from
    TRAIN_SEED (``init_variables``)."""
    from css_tpu_torch.models import build_model, from_jax, init_variables
    from css_tpu_torch.objectives import build_objective
    from css_tpu_torch.trainer.loop import Trainer
    from css_tpu_torch.trainer.lr_schedule import LRSchedule

    conf = dict(conf, mse_noise_weight=0.3)
    model = build_model(name, conf)
    model.load_state_dict(from_jax(model, *init_variables(model,
                                                          TRAIN_SEED)))
    return Trainer(model, build_objective(objective, conf), LRSchedule(lr),
                   optim="adam", weight_decay=1e-2, grad_thresh=5.0,
                   input_domain="time" if name == "ConvTasNet" else "stft",
                   device=dev, seed=TRAIN_SEED)


def step_ms(torch, trainer, batch, steps: int, warmup: int = 1, dmix=None):
    """Median host ms of warm train steps, each ending in a synchronize,
    and the losses of all steps (an encoded recipe batch with its
    DeviceMixer ``dmix``)."""
    times, losses = [], []
    for i in range(warmup + steps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        m = trainer.train_step(batch, dmix)
        torch.cuda.synchronize()
        if i >= warmup:
            times.append((time.perf_counter() - t) * 1e3)
        losses.append(float(m["loss"]))
    return float(np.median(times)), losses


def grads_of(torch, trainer):
    return [p.grad.detach().clone() for p in trainer.model.parameters()]


def rel_l2(torch, got, want) -> float:
    num = torch.sqrt(sum(torch.sum(torch.square(g - w))
                         for g, w in zip(got, want)))
    den = torch.sqrt(sum(torch.sum(torch.square(w)) for w in want))
    return float(num / den)


def k3_record(torch, stft_mag_cuda, x, frame, hop, label):
    """K3 on x (rows, N): launched once against its plain version, its
    event, device and CUDA-graph times beside the plain version's and
    torch.stft(...).abs()'s, and its bound: per frame a window multiply,
    a real FFT and |.| of every bin; the signal read once, the magnitudes
    written once."""
    got = counted(stft_mag_cuda.stft_mag, 1, label,
                  lambda: stft_mag_cuda.stft_mag(x, frame, hop))
    want = stft_mag_cuda.stft_mag_plain(x, frame, hop)
    torch.cuda.synchronize()
    err = check_close(label, got, want, KERNEL_ATOL, KERNEL_RTOL)
    hann = torch.hann_window(frame, device=x.device)

    def lib_fn():
        return torch.stft(x, frame, hop, window=hann, center=False,
                          return_complex=True).abs()

    bins, t = got.shape[2], got.shape[1]
    bnd, by = bound_ms(x.shape[0] * t * (frame + rfft_flops(frame)
                                         + 4 * bins),
                       4.0 * (x.numel() + got.numel()))
    rec = {"shape": list(x.shape), "max_abs_err": err,
           "ms": time_ms(torch, lambda: stft_mag_cuda.stft_mag(x, frame,
                                                               hop)),
           "device_ms": device_ms(torch, lambda: stft_mag_cuda.stft_mag(
               x, frame, hop)),
           "plain_ms": time_ms(torch, lambda: stft_mag_cuda.stft_mag_plain(
               x, frame, hop)),
           "library_ms": time_ms(torch, lib_fn),
           "library_device_ms": device_ms(torch, lib_fn),
           "graph_ms": graph_ms(torch, lambda: stft_mag_cuda.stft_mag(
               x, frame, hop)),
           "library_graph_ms": graph_ms(torch, lib_fn),
           "bound_ms": bnd, "bound_by": by}
    log(f"K3 {label} {tuple(x.shape)}: {json.dumps(rec)}")
    return rec


def k1_record(torch, istft_cuda, spec, frame, hop, label):
    """K1 on spec (rows, T, bins) complex64: launched once against its
    plain version, its event, device and CUDA-graph times beside the
    plain version's, and its bound: per frame an inverse real FFT and a
    window multiply, per sample an overlap add and the envelope multiply;
    the spectrum read once, the signal written once. No library time:
    torch.istft(center=False) refuses the periodic Hann window (its
    envelope is 0 at the first sample: the NOLA check fails)."""
    got = counted(istft_cuda.istft, 1, label,
                  lambda: istft_cuda.istft(spec, frame, hop))
    want = istft_cuda.istft_plain(spec, frame, hop)
    torch.cuda.synchronize()
    err = check_close(label, got, want, KERNEL_ATOL, KERNEL_RTOL)
    rows, t = spec.shape[0], spec.shape[1]
    bnd, by = bound_ms(rows * t * (frame + rfft_flops(frame))
                       + 2.0 * got.numel(),
                       8.0 * spec.numel() + 4.0 * got.numel())
    rec = {"shape": list(spec.shape), "max_abs_err": err,
           "ms": time_ms(torch, lambda: istft_cuda.istft(spec, frame, hop)),
           "device_ms": device_ms(torch, lambda: istft_cuda.istft(
               spec, frame, hop)),
           "plain_ms": time_ms(torch, lambda: istft_cuda.istft_plain(
               spec, frame, hop)),
           "graph_ms": graph_ms(torch, lambda: istft_cuda.istft(
               spec, frame, hop)),
           "library_ms": None, "bound_ms": bnd, "bound_by": by}
    log(f"K1 {label} {tuple(spec.shape)}: {json.dumps(rec)}")
    return rec


def tf32_truncated(torch, x):
    """x (float32) with its mantissa cut to TF32's 10 bits."""
    return (x.view(torch.int32) & -8192).view(torch.float32)


def lstm_single_tf32(torch, xw, w_hh, hidden, state):
    """The control for K2's tight float32 bound with a carried state: the
    plain version's recurrence with both operands of every product cut to
    TF32 (a single-TF32 product, which no cuBLAS kernel choice can turn
    back into a float32 one), from ``state``."""
    h, c = state
    w = tf32_truncated(torch, w_hh.float())
    out = torch.empty_like(xw[..., :hidden])
    for t in range(xw.shape[1]):
        gates = xw[:, t] + tf32_truncated(torch, h.contiguous()) @ w
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        out[:, t] = h
    return out


def k2_stream_record(torch, lstm_cuda, dev):
    """K2 with a carried state at the hop path's chunk, (1, HOP_CHUNK,
    4096) at the causal BLSTM's hidden 1024, on row 0 of a layer's inputs
    (lstm_layer_inputs), its state carried from the plain version over the
    chunk before: float32 against the plain version within KERNEL_ATOL /
    RTOL and LSTM_F32_MAX_ERR (hs and the final h and c), which a
    single-TF32 recurrence must fail; bf16 within LSTM_BF16_ATOL; launches
    chained over HOP_CHAIN_CHUNKS chunks against one launch over their
    frames; the event, device and CUDA-graph times beside the plain
    version's and cuDNN's (``torch.nn.LSTM`` from (h0, c0), the input
    projection included), and the bound: the recurrent products at
    3xTF32's rate against W_hh, xw, h0 and c0 read once and hs and c
    written once."""
    hidden = 1024
    x, w_ih, bias, w_hh, xw = lstm_layer_inputs(torch, dev, hidden)
    x, xw = x[:1].contiguous(), xw[:1].contiguous()
    n = HOP_CHUNK
    _, state = lstm_cuda.lstm_plain(xw[:, :n], w_hh, hidden,
                                    return_state=True)
    xc = xw[:, n: 2 * n].contiguous()
    label = "lstm_fused stream h1024 float32"
    got, (h_t, c_t) = counted(
        lstm_cuda.lstm_fused, 1, label,
        lambda: lstm_cuda.lstm_fused(xc, w_hh, hidden, state=state,
                                     return_state=True))
    want, (wh, wc) = lstm_cuda.lstm_plain(xc, w_hh, hidden, state=state,
                                          return_state=True)
    torch.cuda.synchronize()
    err = max(check_close(label, a, b, KERNEL_ATOL, KERNEL_RTOL)
              for a, b in ((got, want), (h_t, wh), (c_t, wc)))
    if err > LSTM_F32_MAX_ERR:
        raise AssertionError(f"{label}: max abs err {err:.3e} > "
                             f"{LSTM_F32_MAX_ERR} (3xTF32's bound)")
    ctrl_err = float((lstm_single_tf32(torch, xc, w_hh, hidden, state)
                      - want).abs().max())
    if not ctrl_err > LSTM_F32_MAX_ERR:
        raise AssertionError(
            f"{label}: a single-TF32 recurrence passes the float32 bound "
            f"{LSTM_F32_MAX_ERR} (max abs err {ctrl_err:.3e})")
    # bf16, its state carried in bf16 (h) and float32 (c)
    xb, wb = xc.bfloat16(), w_hh.bfloat16()
    sb = (state[0].bfloat16(), state[1])
    gb = counted(lstm_cuda.lstm_fused, 1, label + " bf16",
                 lambda: lstm_cuda.lstm_fused(xb, wb, hidden, state=sb))
    err_b = check_close(label + " bf16", gb.float(), lstm_cuda.lstm_plain(
        xb, wb, hidden, state=sb).float(), LSTM_BF16_ATOL, 0.0)
    # chained over chunks against one launch over the same frames
    whole = xw[:, : HOP_CHAIN_CHUNKS * n].contiguous()
    one, (_, c_one) = counted(
        lstm_cuda.lstm_fused, 1, "lstm_fused one launch",
        lambda: lstm_cuda.lstm_fused(whole, w_hh, hidden, return_state=True))

    def chained():
        st, parts = None, []
        for lo in range(0, whole.shape[1], n):
            hs, st = lstm_cuda.lstm_fused(whole[:, lo: lo + n].contiguous(),
                                          w_hh, hidden, state=st,
                                          return_state=True)
            parts.append(hs)
        return torch.cat(parts, dim=1), st

    chain, (_, c_chain) = counted(lstm_cuda.lstm_fused, HOP_CHAIN_CHUNKS,
                                  "lstm_fused chained", chained)
    chain_err = max(float((chain - one).abs().max()),
                    float((c_chain - c_one).abs().max()))
    if chain_err > LSTM_F32_MAX_ERR:
        raise AssertionError(f"K2 chained over {HOP_CHAIN_CHUNKS} chunks vs "
                             f"one launch: max abs err {chain_err:.3e} > "
                             f"{LSTM_F32_MAX_ERR}")

    def fn():
        return lstm_cuda.lstm_fused(xc, w_hh, hidden, state=state,
                                    return_state=True)

    ref = torch.nn.LSTM(1024, hidden, batch_first=True).to(dev)
    with torch.no_grad():
        ref.weight_ih_l0.copy_(w_ih)
        ref.weight_hh_l0.copy_(w_hh.t())
        ref.bias_ih_l0.copy_(bias)
        ref.bias_hh_l0.zero_()
        xin = x[:, n: 2 * n].contiguous()
        hc = (state[0][None].contiguous(), state[1][None].contiguous())

        def lib_fn():
            return ref(xin, hc)

        lib_err = float((lib_fn()[0] - want).abs().max())
        lib_ms = time_ms(torch, lib_fn)
        lib_dev = device_ms(torch, lib_fn)
    flops, nbytes = lstm_work(1, n, hidden, 4)
    bnd, by = bound_ms(flops, nbytes + 4.0 * 3 * hidden, PEAK_3XTF32_FLOPS)
    rec = {"shape": list(xc.shape), "hidden": hidden, "max_abs_err": err,
           "single_tf32_control_err": ctrl_err, "bf16_max_abs_err": err_b,
           "chained_chunks": HOP_CHAIN_CHUNKS, "chained_max_abs_err":
           chain_err, "chained_bit_equal": bool(chain_err == 0.0),
           "ms": time_ms(torch, fn), "device_ms": device_ms(torch, fn),
           "graph_ms": graph_ms(torch, fn),
           "plain_ms": time_ms(torch, lambda: lstm_cuda.lstm_plain(
               xc, w_hh, hidden, state=state, return_state=True)),
           "library_ms": lib_ms, "library_device_ms": lib_dev,
           "library_max_abs_diff": lib_err, "bound_ms": bnd,
           "bound_by": by}
    log(f"K2 {label} {tuple(xc.shape)}: {json.dumps(rec)}")
    return rec


def stream_window_run(torch, pipe, wav, label, counters, expect):
    """One window-mode streaming run of ``wav`` in PUSH_SEC pushes, then
    flush, launch and plain-route counts reset just before and read just
    after; expect=None (a plain run) skips the count checks. Returns the
    (K, T) streams and the run's record: per-push wall seconds (median,
    p90), the emitted audio's lag behind the input (median, max, seconds),
    and the most audio and mask frames the pipeline retained."""
    for c in counters:
        c.launches = 0
        c.plain_routes = 0
    sr = pipe.sr
    push = int(PUSH_SEC * sr)
    outs, push_s, lags = [], [], []
    pushed = emitted = 0
    max_buf = max_masks = 0
    t_run = time.perf_counter()
    for i in range(0, wav.shape[-1], push):
        t = time.perf_counter()
        out = pipe.push(wav[..., i: i + push])
        torch.cuda.synchronize()
        push_s.append(time.perf_counter() - t)
        outs.append(out)
        pushed += min(push, wav.shape[-1] - i)
        emitted += out.shape[-1]
        if emitted:
            lags.append((pushed - emitted) / sr)
        max_buf = max(max_buf, pipe._buf.shape[-1])
        if pipe._mask_sum is not None:
            max_masks = max(max_masks, pipe._mask_sum.shape[0])
    outs.append(pipe.flush())
    sec = time.perf_counter() - t_run
    full = np.concatenate(outs, axis=-1)
    counts = {c.__name__: c.launches for c in counters}
    routes = {c.__name__: c.plain_routes for c in counters}
    if expect is not None and (counts != expect or any(routes.values())):
        raise AssertionError(f"stream {label}: launches {counts}, plain "
                             f"routes {routes}, expected {expect} and none")
    if full.shape != (2, wav.shape[-1]) or not np.isfinite(full).all():
        raise AssertionError(f"stream {label}: bad streams {full.shape}")
    if (max_buf > STREAM_BUFFER_WINDOWS * pipe.win or max_masks
            > STREAM_BUFFER_WINDOWS * pipe.beamformer.mask_win):
        raise AssertionError(
            f"stream {label}: retained {max_buf} samples and {max_masks} "
            f"mask frames, above {STREAM_BUFFER_WINDOWS} windows")
    rec = {"run_s": sec, "pushes": len(push_s),
           "push_s_median": float(np.median(push_s)),
           "push_s_p90": float(np.percentile(push_s, 90)),
           "lag_s_median": float(np.median(lags)),
           "lag_s_max": float(np.max(lags)),
           "max_retained_samples": max_buf, "max_retained_frames": max_masks,
           "launches": counts, "plain_routes": routes}
    log(f"stream {label}: {json.dumps(rec)}")
    return full, rec


def peak_normalised(streams):
    """Each stream scaled to peak 0.9, as the offline path normalises."""
    return [o * 0.9 / max(float(np.abs(o).max()), 1e-12) for o in streams]


def hop_features(torch, wav, dev):
    """The hop path's magnitudes of ``wav``: uncentered frames times the
    rDFT analysis matrix, |.| -> (1, T, bins) on ``dev``, as
    HopStreamingPipeline computes them chunk by chunk."""
    from css_tpu_torch.ops import stft as stft_ops

    sep = CONFIG["separation"]
    frames = stft_ops.frame_signal(torch.as_tensor(wav, device=dev),
                                   sep["frame_length"], sep["frame_shift"])
    spec = frames @ torch.as_tensor(
        stft_ops.stft_analysis_kernel(sep["frame_length"]), device=dev)
    bins = spec.shape[-1] // 2
    return torch.sqrt(spec[:, :bins] ** 2 + spec[:, bins:] ** 2)[None]


def stream_masks_gate(torch, model, mag, chunks, label):
    """``model.stream`` chained over ``chunks`` (frame counts) against the
    offline causal forward's masks, within HOP_MASK_RTOL / HOP_MASK_ATOL."""
    with torch.no_grad():
        _, full = model(mag)
    carry, outs, lo = model.stream_init(1), [], 0
    for n in chunks:
        m, carry = model.stream(mag[:, lo: lo + n], carry)
        outs.append(m)
        lo += n
    if lo != mag.shape[1]:
        raise AssertionError(f"{label}: chunks cover {lo} of "
                             f"{mag.shape[1]} frames")
    got = torch.cat(outs, dim=1)
    diff = (got - full).abs()
    worst = float((diff - HOP_MASK_RTOL * full.abs()).max())
    err = float(diff.max())
    if worst > HOP_MASK_ATOL or not bool(got.isfinite().all()):
        raise AssertionError(f"{label}: chained stream masks vs the causal "
                             f"forward: max abs err {err:.3e} (rtol "
                             f"{HOP_MASK_RTOL}, atol {HOP_MASK_ATOL})")
    return err


def hop_run(torch, pipe, wav, sizes):
    """``wav`` pushed into a HopStreamingPipeline in pieces of ``sizes``
    (cycled), then flush: the (K, T) streams, and the wall seconds of each
    push that ran a chunk (synchronised)."""
    outs, chunk_s, pos, i = [], [], 0, 0
    while pos < wav.shape[-1]:
        n = sizes[i % len(sizes)]
        t = time.perf_counter()
        out = pipe.push(wav[pos: pos + n])
        torch.cuda.synchronize()
        if out.shape[-1]:
            chunk_s.append(time.perf_counter() - t)
        outs.append(out)
        pos, i = pos + n, i + 1
    outs.append(pipe.flush())
    full = np.concatenate(outs, axis=-1)
    if full.shape != (2, wav.shape[-1]) or not np.isfinite(full).all():
        raise AssertionError(f"hop stream: bad streams {full.shape}")
    return full, chunk_s


def push_invariance(torch, make_pipe, wav, label):
    """One chunk a push against irregular pushes, within HOP_PUSH_RTOL /
    HOP_PUSH_ATOL; returns the first run's streams and per-chunk seconds
    and the largest difference."""
    chunk = HOP_CHUNK * CONFIG["separation"]["frame_shift"]
    a, chunk_s = hop_run(torch, make_pipe(), wav, [chunk])
    b, _ = hop_run(torch, make_pipe(), wav, [700, 3000, 11, 8000])
    diff = np.abs(a - b)
    if (diff > HOP_PUSH_ATOL + HOP_PUSH_RTOL * np.abs(b)).any():
        raise AssertionError(f"{label}: push sizes change the output by "
                             f"{diff.max():.3e}")
    return a, chunk_s, float(diff.max())


def stream_path(torch, dev, results, counters, kernels, mix, srcs, gate,
                boundaries, smi_line):
    """Phase 8 (module docstring); returns the stream record."""
    from css_tpu_torch.cli.separate import load_model
    from css_tpu_torch.executor.hop_streaming import HopStreamingPipeline
    from css_tpu_torch.executor.pipeline import CssPipeline
    from css_tpu_torch.executor.streaming import StreamingCssPipeline
    from css_tpu_torch.models import (blstm, build_model,
                                      state_dict_from_checkpoint)
    from css_tpu_torch.trainer.checkpoint import load_checkpoint

    stft_mag_cuda, istft_cuda, lstm_cuda = kernels
    shapes = main_shapes()
    frame, hop, n_windows = shapes["frame"], shapes["hop"], shapes["n_windows"]
    sr = CONFIG["sampling_rate"]
    record = {}

    # K3 and K1 at the window mode's shapes: one separator window, and one
    # emitted window's K = 2 masked streams
    x = torch.as_tensor(mix[None, : shapes["win"]].copy(), device=dev)
    k3_stream = k3_record(torch, stft_mag_cuda, x, frame, hop,
                          "stft_mag stream")
    spec = istft_input(torch, dev)[:2].contiguous()
    k1_stream = k1_record(torch, istft_cuda, spec, frame, hop,
                          "istft stream")
    del x, spec

    # (a) window mode, the flagship
    model = load_model(CHECKPOINT)
    model.compute_dtype = torch.float32
    expect = {"stft_mag": n_windows, "istft": n_windows, "lstm_fused": 0}

    def window(cfg, wav, label, plain=False):
        pipe = StreamingCssPipeline(model, cfg, device=dev)
        if not plain:
            return stream_window_run(torch, pipe, wav, label, counters,
                                     expect)
        with plain_kernels(stft_mag_cuda, istft_cuda, lstm_cuda):
            out, rec = stream_window_run(torch, pipe, wav, label, counters,
                                         None)
        if any(rec["launches"].values()):
            raise AssertionError(f"plain stream launched {rec['launches']}")
        return out, rec

    window(CONFIG, mix, "window float32 (cold)")
    out_f, rec_f = window(CONFIG, mix, "window float32")
    offline = CssPipeline(model, CONFIG, device=dev).process(mix)
    norm_f = peak_normalised(out_f)
    off_err = max(float(np.abs(a - b).max()) for a, b in zip(norm_f, offline))
    if off_err > STREAM_OFFLINE_ATOL:
        raise AssertionError(f"window stream vs CssPipeline.process: max abs "
                             f"err {off_err:.3e} > {STREAM_OFFLINE_ATOL}")
    out_p, _ = window(CONFIG, mix, "window float32 plain", plain=True)
    plain_err = max(float(np.abs(a - b).max()) for a, b in
                    zip(norm_f, peak_normalised(out_p)))
    if plain_err > PIPE_ATOL:
        raise AssertionError(f"window stream with kernels vs plain: max abs "
                             f"err {plain_err:.3e} > {PIPE_ATOL}")
    model.compute_dtype = torch.bfloat16
    out_h, rec_h = window(CONFIG, mix, "window bf16")
    norm_h = peak_normalised(out_h)
    for where, start in boundaries.items():
        if gate(f"stream control, float32 swapped from the {where} "
                f"boundary", swapped_from(norm_f, start), norm_f)[0]:
            raise AssertionError(f"the bf16 gate passes the float32 stream "
                                 f"swapped from the {where} boundary")
    ok, snr = gate("stream bf16 vs float32", norm_h, norm_f)
    if not ok:
        raise AssertionError("stream bf16 vs float32: below the gate's "
                             "floors")
    record["window"] = {"float32": rec_f, "bf16": rec_h,
                        "vs_offline_max_abs_err": off_err,
                        "vs_plain_max_abs_err": plain_err,
                        "bf16_si_snr_db": snr}
    print("stream_window " + json.dumps(record["window"]), flush=True)
    del model

    # (b) window mode, the 7ch checkpoint on phase 5's session
    model = load_model(CHECKPOINT_7CH)
    model.compute_dtype = torch.float32
    rec7 = session_7ch(srcs)
    out7, rec_7 = window(CONFIG_7CH, rec7, "window 7ch float32")
    off7 = CssPipeline(model, CONFIG_7CH, device=dev).process(rec7)
    off7_err = max(float(np.abs(a - b).max()) for a, b in
                   zip(peak_normalised(out7), off7))
    if off7_err > STREAM_OFFLINE_ATOL:
        raise AssertionError(f"7ch window stream vs CssPipeline.process: max "
                             f"abs err {off7_err:.3e} > {STREAM_OFFLINE_ATOL}")
    record["window_7ch"] = dict(rec_7, vs_offline_max_abs_err=off7_err)
    print("stream_window_7ch " + json.dumps(record["window_7ch"]), flush=True)
    del model, rec7
    torch.cuda.empty_cache()

    wav = mix[: int(HOP_SEC * sr)]
    mag = hop_features(torch, wav, dev)
    t_frames = mag.shape[1]
    chunks = [HOP_CHUNK] * (t_frames // HOP_CHUNK)
    chunks += [t_frames - sum(chunks)] if t_frames % HOP_CHUNK else []

    def counted_steps(pipe):
        """Count the pipeline's device steps (one chunk each)."""
        step, pipe.steps = pipe._step, 0

        def wrapped(frames):
            pipe.steps += 1
            return step(frames)

        pipe._step = wrapped
        return pipe

    # (c) hop mode, a causal BLSTM at full width from a numpy seed
    conf = {"blstm_hdim": 1024, "blstm_num_layers": 3, "blstm_causal": True}
    model = blstm.BLSTM.build_model(conf)
    model.load_state_dict(blstm.params_from_jax(
        blstm.init_params(HOP_SEED, conf)))
    model = model.to(dev).eval()
    n_layers = len(model.encoders)
    mask_err = counted(lstm_cuda.lstm_fused, n_layers * (len(chunks) + 1),
                       "hop blstm masks", lambda: stream_masks_gate(
                           torch, model, mag, chunks, "hop blstm"))
    pipes = []

    def blstm_pipe():
        pipes.append(counted_steps(HopStreamingPipeline(
            model, CONFIG, chunk_frames=HOP_CHUNK, device=dev)))
        return pipes[-1]

    for c in counters:
        c.launches = 0
        c.plain_routes = 0
    out_c, chunk_s, push_err = push_invariance(torch, blstm_pipe, wav,
                                               "hop blstm")
    counts = {c.__name__: c.launches for c in counters}
    routes = {c.__name__: c.plain_routes for c in counters}
    steps = sum(p.steps for p in pipes)
    if (counts != {"stft_mag": 0, "istft": 0,
                   "lstm_fused": n_layers * steps} or any(routes.values())):
        raise AssertionError(f"hop blstm: launches {counts}, plain routes "
                             f"{routes}, expected {n_layers} K2 a chunk over "
                             f"{steps} chunks and none")
    model.compute_dtype = torch.bfloat16
    out_cb, _ = hop_run(torch, HopStreamingPipeline(
        model, CONFIG, chunk_frames=HOP_CHUNK, device=dev), wav,
        [HOP_CHUNK * hop])
    record["hop_blstm"] = {
        "seconds": HOP_SEC, "frames": t_frames, "chunk_frames": HOP_CHUNK,
        "chunks_per_run": pipes[0].steps,
        "k2_per_chunk": n_layers, "launches": counts,
        "chunk_s_median": float(np.median(chunk_s)),
        "chunk_s_p90": float(np.percentile(chunk_s, 90)),
        "stream_vs_offline_masks_max_abs_err": mask_err,
        "push_invariance_max_abs_diff": push_err,
        "bf16_finite": bool(np.isfinite(out_cb).all()),
        "bf16_vs_float32_max_abs_diff": float(np.abs(out_cb - out_c).max())}
    print("stream_hop_blstm " + json.dumps(record["hop_blstm"]), flush=True)
    del model, pipes
    torch.cuda.empty_cache()

    # (d) hop mode, the flagship's weights in a causal Conformer
    ckpt = load_checkpoint(CHECKPOINT)
    model = build_model("Conformer", dict(
        ckpt.get("conf", {}), conformer_causal=True,
        conformer_left_context=HOP_LEFT_CONTEXT))
    model.load_state_dict(state_dict_from_checkpoint("Conformer", ckpt))
    model = model.to(dev).eval()
    model.compute_dtype = torch.float32
    # one chunk longer than the left context, the rest of HOP_CHUNK frames
    long_chunk = 2 * HOP_LEFT_CONTEXT
    head = [HOP_CHUNK] * 8 + [long_chunk]
    rest = t_frames - sum(head)
    conf_chunks = head + [HOP_CHUNK] * (rest // HOP_CHUNK) + (
        [rest % HOP_CHUNK] if rest % HOP_CHUNK else [])
    mask_err_c = stream_masks_gate(torch, model, mag, conf_chunks,
                                   "hop conformer")
    for c in counters:
        c.launches = 0
        c.plain_routes = 0
    _, chunk_c, push_err_c = push_invariance(
        torch, lambda: HopStreamingPipeline(model, CONFIG,
                                            chunk_frames=HOP_CHUNK,
                                            device=dev), wav, "hop conformer")
    routes = {c.__name__: c.plain_routes for c in counters}
    if any(routes.values()):
        raise AssertionError(f"hop conformer: plain routes {routes}")
    record["hop_conformer"] = {
        "seconds": HOP_SEC, "left_context": HOP_LEFT_CONTEXT,
        "longest_chunk": long_chunk,
        "launches": {c.__name__: c.launches for c in counters},
        "chunk_s_median": float(np.median(chunk_c)),
        "chunk_s_p90": float(np.percentile(chunk_c, 90)),
        "stream_vs_offline_masks_max_abs_err": mask_err_c,
        "push_invariance_max_abs_diff": push_err_c}
    print("stream_hop_conformer " + json.dumps(record["hop_conformer"]),
          flush=True)
    del model, mag
    torch.cuda.empty_cache()

    for r in results:
        name = r["name"]
        r["launches_by_path"]["stream_window"] = rec_f["launches"][name]
        r["launches_by_path"]["stream_window_7ch"] = rec_7["launches"][name]
        r["launches_by_path"]["stream_hop_blstm"] = \
            record["hop_blstm"]["launches"][name]
        r["launches_by_path"]["stream_hop_conformer"] = \
            record["hop_conformer"]["launches"][name]
        if name == "stft_mag":
            r["stream"] = dict(k3_stream, launches="1 per separator window "
                               f"({n_windows} a 60 s session)")
        elif name == "istft":
            r["stream"] = dict(k1_stream, launches="1 per emitted window "
                               f"({n_windows} a 60 s session)")
    record["smi"] = smi_line
    return record


def kernel_step_gate(torch, trainer, batch, control, label, kernels):
    """Gate (a) of the train paths: one float32 step's loss, pre-clip
    gradient norm and gradients from one state, featurized by K3 (one
    launch) and by its plain version, held to TRAIN_*; the gradient of
    ``control``, another batch, must fail the gradient gate. The trainer
    is left in its first state. Returns the record."""
    stft_mag_cuda = kernels[0]
    state0 = trainer.state()

    def step_grads(plain: bool, which=batch):
        trainer.load_state(state0)
        trainer.generator.manual_seed(TRAIN_SEED)
        if plain:
            with plain_kernels(*kernels):
                loss, _, norm = trainer.compute_grads(which)
        else:
            loss, _, norm = counted(stft_mag_cuda.stft_mag, 1, label,
                                    lambda: trainer.compute_grads(which))
        return float(loss.detach()), float(norm), grads_of(torch, trainer)

    loss_k, norm_k, g_k = step_grads(False)
    loss_p, norm_p, g_p = step_grads(True)
    _, _, g_ctrl = step_grads(False, control)
    l2 = rel_l2(torch, g_k, g_p)
    l2_ctrl = rel_l2(torch, g_ctrl, g_p)
    elem = max(float((a - c).abs().max() / max(float(c.abs().max()), 1e-30))
               for a, c in zip(g_k, g_p))
    check = {"loss_kernel": loss_k, "loss_plain": loss_p,
             "loss_rel": abs(loss_k - loss_p) / abs(loss_p),
             "grad_norm_rel": abs(norm_k - norm_p) / norm_p,
             "grad_rel_l2": l2, "control_grad_rel_l2": l2_ctrl,
             "max_elem_err_of_tensor_max": elem}
    if not (check["loss_rel"] <= TRAIN_LOSS_RTOL
            and check["grad_norm_rel"] <= TRAIN_NORM_RTOL
            and l2 <= TRAIN_GRAD_L2 and np.isfinite(loss_k)):
        raise AssertionError(f"{label}: step with K3 vs plain: {check}")
    if not l2_ctrl > TRAIN_GRAD_L2:
        raise AssertionError(f"{label}: the gradient gate passes another "
                             f"batch's gradient ({l2_ctrl:.3e})")
    trainer.load_state(state0)
    return check


def train_path(torch, dev, results, counters, stft_mag_cuda, istft_cuda,
               lstm_cuda, mix):
    """Phase 6 (module docstring); returns the train_steps record."""
    import tempfile
    from pathlib import Path

    from css_tpu_torch.cli import train as train_cli
    from css_tpu_torch.cli.separate import load_model
    from css_tpu_torch.executor.pipeline import CssPipeline
    from css_tpu_torch.models import state_dict_from_checkpoint
    from css_tpu_torch.trainer.checkpoint import load_checkpoint, tree_leaves

    sr = CONFIG["sampling_rate"]
    frame, hop = main_shapes()["frame"], main_shapes()["hop"]
    batch = train_batch(TRAIN_SEED)
    b, n = batch["mix"].shape
    audio_sec = b * n / sr

    # K3 at the training shape: the stacked mix and sources of the batch
    x = torch.as_tensor(np.concatenate([batch["mix"], batch["source1"],
                                        batch["source2"]]), device=dev)
    k3 = k3_record(torch, stft_mag_cuda, x, frame, hop, "stft_mag train")
    for r in results:
        if r["name"] == "stft_mag":
            r["train"] = k3
    del x

    # (a) K3 vs plain in one float32 step from one state
    trainer = make_trainer(torch, "Conformer", {}, 1e-4, dev)
    check_a = kernel_step_gate(torch, trainer, batch,
                               train_batch(TRAIN_SEED + 1), "train (a)",
                               (stft_mag_cuda, istft_cuda, lstm_cuda))
    print("train_check_a " + json.dumps(check_a), flush=True)
    f32_ms, _ = step_ms(torch, trainer, batch, 5, warmup=2)
    del trainer
    torch.cuda.empty_cache()

    # (b) descent in bf16 on one batch, and the lr 0 control
    drops = {}
    for lr in (DESCENT_LR, 0.0):
        trainer = make_trainer(torch, "Conformer", {"bf16": True}, lr, dev)
        ms, losses = step_ms(torch, trainer, batch, DESCENT_STEPS - 1)
        drops[lr] = 1.0 - float(np.mean(losses[-5:])) / losses[0]
        if lr:
            bf16_ms, descent = ms, losses
            kept = trainer
        else:
            del trainer
    print("train_descent " + json.dumps({
        "lr": DESCENT_LR, "steps": DESCENT_STEPS, "losses": descent,
        "drop": drops[DESCENT_LR], "control_lr0_drop": drops[0.0],
        "min_drop": DESCENT_MIN_DROP}), flush=True)
    if not (drops[DESCENT_LR] >= DESCENT_MIN_DROP
            and np.isfinite(descent).all()):
        raise AssertionError(f"descent: loss drop {drops[DESCENT_LR]:.3f} < "
                             f"{DESCENT_MIN_DROP}")
    if drops[0.0] >= DESCENT_MIN_DROP:
        raise AssertionError(f"descent control at lr 0 passes the gate "
                             f"({drops[0.0]:.3f})")

    # (d) a non-finite step on the descended trainer
    before = kept.state()
    bad = {k: v.copy() for k, v in batch.items()}
    bad["mix"][0, 100] = np.nan
    m = kept.train_step(bad)
    after = kept.state()
    same = all(np.array_equal(p, q) for p, q in zip(
        tree_leaves(after.params) + tree_leaves(after.batch_stats)
        + after.opt_state, tree_leaves(before.params)
        + tree_leaves(before.batch_stats) + before.opt_state))
    check_d = {"finite": bool(m["finite"]), "state_unchanged": same,
               "step_before": before.step, "step_after": after.step}
    print("train_check_d " + json.dumps(check_d), flush=True)
    if m["finite"] or not same or after.step != before.step + 1:
        raise AssertionError(f"non-finite step: {check_d}")
    del kept, before, after
    torch.cuda.empty_cache()

    # timings: the full-width BLSTM, bf16 and float32
    blstm_ms = {}
    for dtype_name, conf in (("bf16", {"bf16": True}), ("float32", {})):
        trainer = make_trainer(torch, "BLSTM", conf, 1e-4, dev)
        blstm_ms[dtype_name] = step_ms(torch, trainer, batch, 3)[0]
        del trainer
        torch.cuda.empty_cache()

    # (e) Conv-TasNet at its default width, float32 SI-SNR
    from css_tpu_torch.models.conv_tasnet import DEFAULT_CONV_TASNET_CONF

    tas_conf = {f"conv_tasnet_{k}": v
                for k, v in DEFAULT_CONV_TASNET_CONF.items()}
    trainer = make_trainer(torch, "ConvTasNet", tas_conf, 1e-4, dev,
                           objective="SNR")
    tas_batch = {k: v[:4] for k, v in batch.items()}
    tas_ms, tas_losses = step_ms(torch, trainer, tas_batch, 3)
    if not np.isfinite(tas_losses).all():
        raise AssertionError(f"Conv-TasNet losses {tas_losses}")
    del trainer
    torch.cuda.empty_cache()

    # (c) the recipe's run through cli.train, counts reset just before
    with tempfile.TemporaryDirectory() as tmp:
        expdir = Path(tmp) / "exp"
        for c in counters:
            c.launches = c.plain_routes = 0
        t0 = time.perf_counter()
        trainer = train_cli.main(RECIPE_ARGS + [
            "--expdir", str(expdir), "--num-epochs", str(RECIPE_EPOCHS),
            "--batches-per-epoch", str(RECIPE_BATCHES),
            "--validate-batches", str(RECIPE_VALID), "--keep-best",
            "--init", CHECKPOINT, "--device", "cuda"])
        recipe_sec = time.perf_counter() - t0
        counts = {c.__name__: c.launches for c in counters}
        routes = {c.__name__: c.plain_routes for c in counters}
        expect = {"stft_mag": RECIPE_EPOCHS * (RECIPE_BATCHES
                                               + RECIPE_VALID),
                  "istft": 0, "lstm_fused": 0}
        if counts != expect or any(routes.values()):
            raise AssertionError(f"recipe run: launches {counts}, plain "
                                 f"routes {routes}, expected {expect}")
        files = sorted(p.name for p in expdir.iterdir())
        want_files = sorted([f"{e}.1.mdl" for e in range(1, RECIPE_EPOCHS
                                                         + 1)]
                            + ["best.1.mdl", "conf.1.json", "train.1.jsonl"])
        with open(expdir / "train.1.jsonl") as fh:
            records = [json.loads(line) for line in fh]
        if files != want_files or len(records) != RECIPE_EPOCHS or not all(
                np.isfinite(r["loss"]) for r in records):
            raise AssertionError(f"recipe run wrote {files}, {records}")
        last = expdir / f"{RECIPE_EPOCHS}.1.mdl"
        ckpt = load_checkpoint(last)
        reloaded = state_dict_from_checkpoint("Conformer", ckpt)
        own = trainer.model.state_dict()
        bit_equal = set(reloaded) == set(own) and all(
            torch.equal(reloaded[k], own[k].cpu()) for k in own)
        if not bit_equal or ckpt["step"] != RECIPE_EPOCHS * RECIPE_BATCHES:
            raise AssertionError("the trained checkpoint does not reload "
                                 "bit-equal")
        del trainer
        model = load_model(str(last))
        outs = CssPipeline(model, CONFIG, device="cuda").process(mix)
    if len(outs) != 2 or any(o.shape != mix.shape or not np.isfinite(o).all()
                             or abs(float(np.abs(o).max()) - 0.9) > 1e-4
                             for o in outs):
        raise AssertionError(f"the trained checkpoint's streams are bad: "
                             f"{[(o.shape, float(np.abs(o).max())) for o in outs]}")
    for r in results:
        r["launches_by_path"]["conformer_train"] = counts[r["name"]]
    print("train_check_c " + json.dumps({
        "seconds": recipe_sec, "launches": counts, "plain_routes": routes,
        "files": files, "losses": [r["loss"] for r in records],
        "reload_bit_equal": bit_equal, "separated": True}), flush=True)
    del model
    torch.cuda.empty_cache()
    return {
        "batch": b, "window_s": n / sr,
        "conformer": {"bf16_ms": bf16_ms, "float32_ms": f32_ms,
                      "bf16_audio_sec_per_s": audio_sec / bf16_ms * 1e3,
                      "float32_audio_sec_per_s": audio_sec / f32_ms * 1e3},
        "blstm": {"bf16_ms": blstm_ms["bf16"],
                  "float32_ms": blstm_ms["float32"],
                  "bf16_audio_sec_per_s": audio_sec / blstm_ms["bf16"] * 1e3,
                  "float32_audio_sec_per_s":
                      audio_sec / blstm_ms["float32"] * 1e3},
        "conv_tasnet": {"batch": 4, "float32_ms": tas_ms,
                        "losses": tas_losses}}


def spatial_mixer(seed: int, level: float):
    """SpatialMixer over the CLI's default corpus: TRAIN_BATCH windows of
    TRAIN_WINDOW_SEC on the 7-mic array, sensor noise ``level``."""
    from css_tpu_torch.data.mixer import MixtureSynthesizer
    from css_tpu_torch.data.spatial import SpatialMixer

    return SpatialMixer(MixtureSynthesizer.build_dataset(
        train_material()[0], {"batch_size": TRAIN_BATCH,
                              "min_window_size": TRAIN_WINDOW_SEC,
                              "max_window_size": TRAIN_WINDOW_SEC,
                              "seed": seed}), noise_level=level,
        seed=seed + 31)


def spatial_batch(seed: int) -> dict:
    """One host-mixed 7ch batch (B, 7, N) with its dry sources."""
    return {k: v for k, v in next(spatial_mixer(seed, SENSOR_NOISE)).items()
            if k not in ("ovl", "lens")}


def mixing_check(torch, dmix, enc, host, label):
    """(b): an encoded recipe materialised on the card against its host
    batch: the mixtures within MIX_ATOL, the sources bit-equal. Returns
    the record, with the materialisation's card time, and the encoded
    recipe on the card."""
    enc_dev = {"dm_i": torch.as_tensor(enc["dm_i"], device=dmix.device),
               "dm_f": torch.as_tensor(enc["dm_f"], device=dmix.device),
               "win": enc["win"]}
    got = dmix.materialize(enc_dev)
    err = float(np.abs(got["mix"].cpu().numpy() - host["mix"]).max())
    same = all(np.array_equal(got[k].cpu().numpy(), host[k])
               for k in got if k.startswith("source"))
    rec = {"shape": list(got["mix"].shape), "mix_max_abs_err": err,
           "mix_peak": float(np.abs(host["mix"]).max()),
           "sources_bit_equal": same,
           "materialize_ms": time_ms(torch, lambda: dmix.materialize(
               enc_dev), reps=10, warmup=1)}
    if not (err <= MIX_ATOL and same):
        raise AssertionError(f"device mixing {label} vs host: {rec}")
    return rec, enc_dev


def train_7ch_path(torch, dev, results, counters, kernels, smi_line):
    """Phase 7 (module docstring); returns the train_7ch record."""
    import tempfile
    from pathlib import Path

    from css_tpu_torch.cli import train as train_cli
    from css_tpu_torch.cli.separate import load_model
    from css_tpu_torch.data.augment import NoiseMix, ReverbWithImpulseResponse
    from css_tpu_torch.data.corpus import SyntheticCorpus
    from css_tpu_torch.data.device_mixer import DeviceMixer
    from css_tpu_torch.data.mixer import MixtureSynthesizer
    from css_tpu_torch.models import state_dict_from_checkpoint
    from css_tpu_torch.objectives import build_objective
    from css_tpu_torch.ops import native
    from css_tpu_torch.trainer.checkpoint import load_checkpoint
    from css_tpu_torch.trainer.loop import Trainer
    from css_tpu_torch.trainer.lr_schedule import LRSchedule
    from css_tpu_torch.trainer.probe import HeldOutProbe

    stft_mag_cuda, istft_cuda, _ = kernels
    frame, hop = main_shapes()["frame"], main_shapes()["hop"]
    batch = spatial_batch(TRAIN_7CH_SEED)
    b, n = batch["mix"].shape[0], batch["mix"].shape[-1]
    # K3 at the 7ch training shape: channel 0 and the sources, stacked
    x = torch.as_tensor(np.concatenate([batch["mix"][:, 0], batch["source1"],
                                        batch["source2"]]), device=dev)
    k3_train = k3_record(torch, stft_mag_cuda, x, frame, hop,
                         "stft_mag train 7ch")
    del x

    # (a) K3 vs plain in one float32 step of the 7ch checkpoint
    model = load_model(CHECKPOINT_7CH)
    trainer = Trainer(model, build_objective("MSE", {"mse_noise_weight": 0.3}),
                      LRSchedule(1e-4), optim="adam", weight_decay=1e-2,
                      grad_thresh=5.0, device=dev, seed=TRAIN_SEED,
                      ipd_index=IPD_7CH)
    model.compute_dtype = torch.float32
    check_a = kernel_step_gate(torch, trainer, batch,
                               spatial_batch(TRAIN_7CH_SEED + 1),
                               "train 7ch (a)", kernels)
    print("train_7ch_check_a " + json.dumps(check_a), flush=True)
    # the step's times, host-mixed and device-mixed (one sample each)
    dmix = DeviceMixer(spatial_mixer(TRAIN_7CH_SEED + 4, SENSOR_NOISE),
                       device=dev)
    enc = next(dmix)
    step = {}
    for name, dtype in (("bf16", torch.bfloat16), ("float32", torch.float32)):
        model.compute_dtype = dtype
        step[f"{name}_host_mix_ms"] = step_ms(torch, trainer, batch, 3)[0]
        step[f"{name}_device_mix_ms"] = step_ms(torch, trainer, enc, 3,
                                                dmix=dmix)[0]
    del trainer, model, dmix
    torch.cuda.empty_cache()

    # (b) device against host mixing of the same recipes
    corpus, rirs, noises = train_material()
    mono = MixtureSynthesizer.build_dataset(corpus, {
        "batch_size": TRAIN_BATCH, "min_window_size": TRAIN_WINDOW_SEC,
        "max_window_size": TRAIN_WINDOW_SEC, "rir_pool": rirs,
        "noise_pool": noises, "seed": TRAIN_7CH_SEED + 2})
    recipe = mono.sample_recipe()
    dmono = DeviceMixer(mono, device=dev)
    check_b = {"1ch_rir_noise": mixing_check(
        torch, dmono, dmono.encode(recipe),
        mono.materialize_recipe_host(recipe), "1ch")[0]}
    quiet = spatial_mixer(TRAIN_7CH_SEED + 3, 0.0)
    dquiet = DeviceMixer(quiet, device=dev)
    recipe = quiet.mixer.sample_recipe()
    enc = dquiet.encode(recipe)  # draws each row's azimuths
    k = quiet.mixer.num_speakers
    host = quiet.spatialize_batch(quiet.mixer.materialize_recipe_host(recipe),
                                  az=np.rad2deg(enc["dm_f"][:, 3:3 + k]))
    check_b["7ch_noise_0"], enc_dev = mixing_check(
        torch, dquiet, enc, host, "7ch")
    noisy = DeviceMixer(spatial_mixer(TRAIN_7CH_SEED + 3, SENSOR_NOISE),
                        device=dev)
    first = noisy.materialize(enc_dev)["mix"]
    again = noisy.materialize(enc_dev)["mix"]
    noise = first - dquiet.materialize(enc_dev)["mix"]
    std = float(noise.std())
    check_b["7ch_sensor_noise"] = {
        "level": SENSOR_NOISE, "std": std,
        "std_rel_err": abs(std / SENSOR_NOISE - 1.0),
        "bit_equal_twice": bool(torch.equal(first, again))}
    print("train_7ch_check_b " + json.dumps(check_b), flush=True)
    if not (check_b["7ch_sensor_noise"]["std_rel_err"] <= NOISE_STD_RTOL
            and check_b["7ch_sensor_noise"]["bit_equal_twice"]):
        raise AssertionError(f"sensor noise: {check_b['7ch_sensor_noise']}")
    del dmono, dquiet, noisy, first, again, noise, enc_dev

    # (c) the 7ch recipe through cli.train, counts reset just before
    with tempfile.TemporaryDirectory() as tmp:
        expdir = Path(tmp) / "exp7"
        for c in counters:
            c.launches = c.plain_routes = 0
        t0 = time.perf_counter()
        trainer = train_cli.main(RECIPE_7CH_ARGS + [
            "--expdir", str(expdir), "--num-epochs", str(RECIPE_7CH_EPOCHS),
            "--batches-per-epoch", str(RECIPE_7CH_BATCHES),
            "--validate-batches", str(RECIPE_7CH_VALID),
            "--init", CHECKPOINT_7CH, "--device", str(dev)])
        recipe_sec = time.perf_counter() - t0
        counts = {c.__name__: c.launches for c in counters}
        routes = {c.__name__: c.plain_routes for c in counters}
        # K3: each train and validation batch, and each probe call (one per
        # epoch and one for the average); K1: each probe call
        probes = RECIPE_7CH_EPOCHS + 1
        expect = {"stft_mag": RECIPE_7CH_EPOCHS * (RECIPE_7CH_BATCHES
                                                   + RECIPE_7CH_VALID)
                  + probes, "istft": probes, "lstm_fused": 0}
        if counts != expect or any(routes.values()):
            raise AssertionError(f"7ch recipe run: launches {counts}, plain "
                                 f"routes {routes}, expected {expect}")
        files = sorted(p.name for p in expdir.iterdir())
        want_files = sorted([f"{e}.1.mdl" for e in range(
            RECIPE_7CH_EPOCHS - 1, RECIPE_7CH_EPOCHS + 1)]
            + ["avgtop.1.mdl", "best.1.mdl", "conf.1.json",
               "train.1.jsonl"])
        with open(expdir / "train.1.jsonl") as fh:
            records = [json.loads(line) for line in fh]
        losses = [r["loss"] for r in records if "loss" in r]
        probe_vals = [r["probe_si_snri_db"] for r in records
                      if "probe_si_snri_db" in r]
        avgtop = [r for r in records if "avgtop_epochs" in r]
        if (files != want_files or len(losses) != RECIPE_7CH_EPOCHS
                or not np.isfinite(losses).all()
                or len(probe_vals) != RECIPE_7CH_EPOCHS
                or not np.isfinite(probe_vals).all() or len(avgtop) != 1):
            raise AssertionError(f"7ch recipe run wrote {files}, {records}")
        last = expdir / f"{RECIPE_7CH_EPOCHS}.1.mdl"
        ckpt = load_checkpoint(last)
        reloaded = state_dict_from_checkpoint("Conformer", ckpt)
        own = trainer.model.state_dict()
        bit_equal = set(reloaded) == set(own) and all(
            torch.equal(reloaded[k], own[k].cpu()) for k in own)
        if (not bit_equal
                or ckpt["step"] != RECIPE_7CH_EPOCHS * RECIPE_7CH_BATCHES):
            raise AssertionError("the 7ch checkpoint does not reload "
                                 "bit-equal")
        del trainer
    for r in results:
        r["launches_by_path"]["conformer_7ch_train"] = counts[r["name"]]
    check_c = {"seconds": recipe_sec, "launches": counts,
               "plain_routes": routes, "files": files, "losses": losses,
               "probe_si_snri_db": probe_vals, "avgtop": avgtop[0],
               "reload_bit_equal": bit_equal}
    print("train_7ch_check_c " + json.dumps(check_c), flush=True)
    torch.cuda.empty_cache()

    # (d) the flagship's probe in float32 against css_tpu's value, and the
    # probe's kernel shapes and seconds per call (the 7ch checkpoint too)
    probe_corpus = SyntheticCorpus(**PROBE_CORPUS)
    probe_kw = dict(sessions=PROBE_SESSIONS, session_sec=PROBE_SESSION_SEC,
                    seed=PROBE_CORPUS["seed"], device=dev)
    check_d = {}
    for label, ckpt_path, kw in (
            ("mask", CHECKPOINT, {"mode": "mask"}),
            ("spatial", CHECKPOINT_7CH, {"mode": "spatial",
                                         "ipd_index": IPD_7CH,
                                         "noise_level": SENSOR_NOISE})):
        model = load_model(ckpt_path).to(dev)
        model.compute_dtype = torch.float32
        probe = HeldOutProbe(probe_corpus, **probe_kw, **kw)
        secs = []
        for _ in range(3):
            for c in counters:
                c.launches = c.plain_routes = 0
            torch.cuda.synchronize()
            t = time.perf_counter()
            val = probe(model)
            secs.append(time.perf_counter() - t)
            counts = {c.__name__: c.launches for c in counters}
            if (counts != {"stft_mag": 1, "istft": 1, "lstm_fused": 0}
                    or any(c.plain_routes for c in counters)):
                raise AssertionError(f"probe {label}: launches {counts}")
        check_d[label] = {"si_snri_db": val, "cold_s": secs[0],
                          "warm_s": float(np.median(secs[1:]))}
        if label == "mask":
            s_, w_ = probe.windows.shape[:2]
            k3_probe = k3_record(torch, stft_mag_cuda, probe.windows.reshape(
                s_ * w_, -1), frame, hop, "stft_mag probe")
            with torch.no_grad():
                est, _ = probe.masked_spectra(model.eval())
            k1_probe = k1_record(torch, istft_cuda, est, frame, hop,
                                 "istft probe")
        del model, probe
    err_d = abs(check_d["mask"]["si_snri_db"] - PROBE_REFERENCE_DB)
    check_d.update({"reference_db": PROBE_REFERENCE_DB, "abs_err_db": err_d,
                    "card": smi_line})
    print("train_7ch_check_d " + json.dumps(check_d), flush=True)
    if not err_d <= PROBE_ATOL_DB or not np.isfinite(
            check_d["spatial"]["si_snri_db"]):
        raise AssertionError(f"probe of the flagship: {check_d}")

    # (e) the native core (built by g++ in phase 1): the mixer's native
    # path (css_tpu's default switches: placing and noise native, reverb
    # in scipy) against the numpy path, and no fall-back in the whole run

    def mono_mixer(use_native):
        m = MixtureSynthesizer(corpus, batch_size=TRAIN_BATCH,
                               min_window=TRAIN_WINDOW_SEC,
                               max_window=TRAIN_WINDOW_SEC,
                               seed=TRAIN_7CH_SEED + 5, use_native=use_native)
        m.transforms = [ReverbWithImpulseResponse(rirs),
                        NoiseMix(noises, use_native=use_native)]
        return m

    calls = native.calls
    got, want = next(mono_mixer(True)), next(mono_mixer(False))
    err_e = float(np.abs(got["mix"] - want["mix"]).max())
    check_e = {"library": native.library_path().name,
               "calls": native.calls - calls, "fallbacks": native.fallbacks,
               "mix_max_abs_err": err_e, "sources_bit_equal": all(
                   np.array_equal(got[k], want[k]) for k in want
                   if k.startswith("source"))}
    print("train_7ch_check_e " + json.dumps(check_e), flush=True)
    if not (check_e["calls"] > 0 and native.fallbacks == 0
            and err_e <= 1e-6 and check_e["sources_bit_equal"]):
        raise AssertionError(f"native core: {check_e}")

    for r in results:
        if r["name"] == "stft_mag":
            r["train_7ch"] = dict(k3_train, launches="1 per step")
            r["probe"] = dict(k3_probe, launches="1 per probe call")
        if r["name"] == "istft":
            r["probe"] = dict(k1_probe, launches="1 per probe call")
    return {"batch": b, "window_s": n / CONFIG["sampling_rate"],
            "step_ms": step, "probe_s": {k: {"cold": v["cold_s"],
                                              "warm": v["warm_s"]}
                                          for k, v in check_d.items()
                                          if isinstance(v, dict)},
            "recipe_s": recipe_sec, "card": smi_line}


def par_arrays(rec: dict, prefix: str) -> dict:
    """A runner result's arrays under ``prefix`` (the prefix cut off)."""
    return {k[len(prefix):]: v for k, v in rec["arrays"].items()
            if k.startswith(prefix)}


def par_rel_l2(got: dict, want: dict) -> float:
    """|got - want| / |want| over every array of two same-keyed dicts."""
    if sorted(got) != sorted(want) or not want:
        raise AssertionError(f"keys differ: {sorted(set(got) ^ set(want))}")
    num = sum(float(np.sum((got[k].astype(np.float64) - want[k]) ** 2))
              for k in want)
    den = sum(float(np.sum(want[k].astype(np.float64) ** 2)) for k in want)
    return float(np.sqrt(num / den))


def par_max_abs(got: dict, want: dict) -> float:
    if sorted(got) != sorted(want) or not want:
        raise AssertionError(f"keys differ: {sorted(set(got) ^ set(want))}")
    return max(float(np.abs(got[k] - want[k]).max()) for k in want)


def par_check_ranks(results, label, launches):
    """Every rank's K3 launches, no plain route, ranks in sync (dp)."""
    for r in results:
        want = {"stft_mag": launches, "istft": 0, "lstm_fused": 0}
        if r["launches"] != want or any(r["plain_routes"].values()):
            raise AssertionError(
                f"{label} rank {r['rank']}: launches {r['launches']} "
                f"(expected {want}), plain routes {r['plain_routes']}")
        if r.get("in_sync") is False:
            raise AssertionError(f"{label} rank {r['rank']}: parameters "
                                 "differ from data rank 0's")


def par_params_gate(rec, ref) -> dict:
    """How far ``rec``'s parameters after the steps lie from ``ref``'s:
    the largest difference, and the elements outside PAR_PARAM_RTOL /
    PAR_PARAM_ATOL (the gate: none)."""
    got, want = par_arrays(rec, "param/"), par_arrays(ref, "param/")
    outside = sum(int(np.sum(np.abs(got[k] - w)
                             > PAR_PARAM_ATOL + PAR_PARAM_RTOL * np.abs(w)))
                  for k, w in want.items())
    return {"params_max_abs": par_max_abs(got, want),
            "params_outside_tol": outside}


def par_gate(label, ref, rec, steps):
    """Rank ``rec`` against the single-process ``ref``: losses, step 0's
    gradients, the BatchNorm statistics after step 0 and (steps > 1) the
    parameters after the steps, at the JAX package's tolerances; returns
    the numbers."""
    loss = max(abs(a - b) / abs(b) for a, b in
               zip(rec["losses"][:steps], ref["losses"][:steps]))
    grad = par_rel_l2(par_arrays(rec, "grad/"), par_arrays(ref, "grad/"))
    stats = par_max_abs(par_arrays(rec, "stats0/"),
                        par_arrays(ref, "stats0/"))
    out = {"loss_rel": loss, "grad_rel_l2": grad, "stats_max_abs": stats}
    ok = (loss <= PAR_LOSS_RTOL and grad <= PAR_GRAD_L2
          and stats <= PAR_STATS_ATOL)
    if steps > 1:
        params = par_params_gate(rec, ref)
        out.update(params)
        ok = ok and params["params_outside_tol"] == 0
    log(f"{label}: {json.dumps(out)} -> {'pass' if ok else 'fail'}")
    return ok, out


def parallel_path(torch, dev, results, counters, mix, smi_line) -> dict:
    """Phase 9 (see PAR_* above): the strategies through
    css_tpu_torch.parallel.runner's ranks, the CLI through the launcher,
    the driver, and sharded separation in this process."""
    import shutil
    import tempfile
    from pathlib import Path

    from css_tpu_torch.models import build_model, init_variables
    from css_tpu_torch.ops import stft_mag_cuda
    from css_tpu_torch.parallel import runner
    from css_tpu_torch.trainer.checkpoint import (load_checkpoint,
                                                  save_checkpoint_dict)

    torch.cuda.empty_cache()
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_parallel_"))
    rec = {"note": "ranks share one card over gloo (world 2) or run alone "
                   "over NCCL (world 1): correctness and overhead, not "
                   "scaling", "card": smi_line}
    try:
        conf = PAR_CONF
        model = build_model("Conformer", conf)

        def write_init(seed, name):
            params, stats = init_variables(model, seed)
            path = work / name
            save_checkpoint_dict(str(path), {"params": params,
                                             "batch_stats": stats})
            return str(path)

        ckpt = load_checkpoint(CHECKPOINT)
        init = str(work / "flagship.mdl")
        save_checkpoint_dict(init, {"params": ckpt["params"],
                                    "batch_stats": ckpt["batch_stats"]})
        batches = [train_batch(PARALLEL_SEED + i) for i in range(PAR_STEPS)]
        runner.save_batches(work / "batches.npz", batches)
        # K3 at a world-2 rank's shape: its 16 rows of mix and sources
        half = TRAIN_BATCH // 2
        x = torch.as_tensor(np.concatenate(
            [batches[0][k][:half] for k in ("mix", "source1", "source2")]),
            device=dev)
        sep = CONFIG["separation"]
        k3 = k3_record(torch, stft_mag_cuda, x, sep["frame_length"],
                       sep["frame_shift"], "stft_mag dp rank")
        for r in results:
            if r["name"] == "stft_mag":
                r["dp_rank"] = dict(k3, launches="1 per step on each rank "
                                    "of a world-2 data-parallel step")
        del x
        base = {"strategy": "dp", "world": 1, "device": dev.type,
                "model": {"name": "Conformer", "conf": conf},
                "objective": {"name": "MSE",
                              "conf": {"mse_noise_weight": 0.3}},
                "trainer": {"optim": "adam", "lr": 1e-4,
                            "weight_decay": 1e-2, "grad_thresh": 5.0,
                            "seed": TRAIN_SEED},
                "init": init, "batches": str(work / "batches.npz"),
                "steps": PAR_STEPS, "timeout_s": PAR_TIMEOUT_S}
        timed = {"timed_steps": PAR_TIMED_STEPS}

        def ms(r):
            return float(np.median(r["timed_ms"]))

        # (a) world 1 over NCCL against single, each in a process of its own
        single = runner.run(dict(base, strategy="single", spawn=True,
                                 **timed), work / "single")[0]
        w1 = runner.run(dict(base, **timed), work / "dp1")[0]
        if w1["backend"] != ("nccl" if dev.type == "cuda" else "gloo"):
            raise AssertionError(f"world 1 on a card ran {w1['backend']}")
        par_check_ranks([w1], "dp world 1", PAR_STEPS)
        a = {"loss_rel": max(abs(x - y) / abs(y) for x, y in
                             zip(w1["losses"], single["losses"])),
             "grad_rel_l2": par_rel_l2(par_arrays(w1, "grad/"),
                                       par_arrays(single, "grad/")),
             "stats_max_rel": max(
                 float(np.abs(v - par_arrays(single, "stats0/")[k]).max()
                       / max(np.abs(v).max(), 1e-30))
                 for k, v in par_arrays(w1, "stats0/").items())}
        log(f"(a) dp world 1 nccl vs single: {json.dumps(a)}")
        if max(a.values()) > WORLD1_RTOL:
            raise AssertionError(f"(a) world-1 DP is not single: {a}")
        rec["a"] = dict(a, step_ms=ms(w1), single_step_ms=ms(single),
                        timed_steps=PAR_TIMED_STEPS, backend=w1["backend"])

        def by_path(path, ranks):
            for r in results:
                r["launches_by_path"][path] = sum(x["launches"][r["name"]]
                                                  for x in ranks)

        # (b) world 2 over gloo on the one card, and the control
        w2 = runner.run(dict(base, world=2, **timed), work / "dp2")
        if [r["backend"] for r in w2] != ["gloo", "gloo"]:
            raise AssertionError(
                f"world 2 backends {[r['backend'] for r in w2]}")
        par_check_ranks(w2, "dp world 2", PAR_STEPS)
        b = []
        for r in w2:
            ok, out = par_gate(f"(b) dp world 2 rank {r['rank']} vs single",
                               single, r, PAR_STEPS)
            if not ok:
                raise AssertionError(f"(b) rank {r['rank']}: {out}")
            b.append(out)
        ctrl = runner.run(dict(base, world=2, steps=1, local_bn=True),
                          work / "ctrl")[0]
        ctrl_l2 = par_rel_l2(par_arrays(ctrl, "grad/"),
                             par_arrays(single, "grad/"))
        log(f"(b) control, per-rank BatchNorm statistics: gradients rel-L2 "
            f"{ctrl_l2:.3e} (must exceed {PAR_GRAD_L2})")
        if not ctrl_l2 > PAR_GRAD_L2:
            raise AssertionError("(b) per-rank BatchNorm passes the "
                                 f"gradient gate ({ctrl_l2:.3e})")
        rec["b"] = {"ranks": b, "control_grad_rel_l2": ctrl_l2,
                    "step_ms": [ms(r) for r in w2]}

        # (c) TP = 2
        tp = runner.run(dict(base, world=2, tp=2, steps=1), work / "tp")
        par_check_ranks(tp, "tp 2", 1)
        c = []
        for r in tp:
            ok, out = par_gate(f"(c) tp 2 rank {r['rank']} vs single",
                               single, r, 1)
            if not ok:
                raise AssertionError(f"(c) rank {r['rank']}: {out}")
            c.append(out)
        # from random weights, against the witness in TP's order of sums
        rand = dict(base, init=write_init(TRAIN_SEED, "random.mdl"), steps=1)
        wit = runner.run(dict(rand, strategy="single", split_like_tp=2),
                         work / "witness")[0]
        plain = runner.run(dict(rand, strategy="single"), work / "plain")[0]
        tp_rand = runner.run(dict(rand, world=2, tp=2), work / "tp_random")
        par_check_ranks(tp_rand, "tp 2 random", 1)
        c_rand = []
        for r in tp_rand:
            ok, out = par_gate(f"(c) tp 2 rank {r['rank']}, random weights, "
                               "vs the witness", wit, r, 1)
            if not ok:
                raise AssertionError(f"(c) random rank {r['rank']}: {out}")
            c_rand.append(out)
        wit_vs_single = {
            "loss_rel": abs(wit["losses"][0] - plain["losses"][0])
            / abs(plain["losses"][0]),
            "grad_rel_l2": par_rel_l2(par_arrays(wit, "grad/"),
                                      par_arrays(plain, "grad/")),
            "tp_grad_rel_l2": [par_rel_l2(par_arrays(r, "grad/"),
                                          par_arrays(plain, "grad/"))
                               for r in tp_rand]}
        log(f"(c) random weights, the witness and tp 2 vs single: "
            f"{json.dumps(wit_vs_single)}")
        rec["c"] = {"ranks": c, "step_ms": [r["step_ms"][0] for r in tp],
                    "random_vs_witness": c_rand,
                    "random_vs_single": wit_vs_single}
        by_path("tp_train", tp)

        # (d) replica averaging: two replicas on their own rows and draws
        inits = [write_init(TRAIN_SEED + j, f"init{j}.mdl") for j in range(2)]
        own = []
        for j in range(2):
            rows = [{k: v[j * half:(j + 1) * half] for k, v in bt.items()}
                    for bt in batches[:REPLICA_STEPS]]
            runner.save_batches(work / f"rows{j}.npz", rows)
            own.append(runner.run(dict(
                base, strategy="single", init=inits[j],
                batches=str(work / f"rows{j}.npz"), steps=REPLICA_STEPS),
                work / f"own{j}")[0])
        ra = runner.run(dict(base, strategy="replica", world=2, init=inits,
                             steps=REPLICA_STEPS,
                             averages=[[True, True], [True, False]]),
                        work / "replica")
        par_check_ranks(ra, "replica", REPLICA_STEPS)
        for j, r in enumerate(ra):
            ok, out = par_gate(f"(d) replica {j}'s own steps vs single",
                               own[j], r, REPLICA_STEPS)
            if not ok:
                raise AssertionError(f"(d) replica {j}: {out}")
        mine = [par_arrays(r, "param/") for r in ra]
        mean = {k: (v + mine[1][k]) / 2 for k, v in mine[0].items()}
        d = {"avg_all_vs_mean": [par_max_abs(par_arrays(r, "avg0/param/"),
                                             mean) for r in ra],
             "avg_alive_1_0_vs_replica_0": [
                 par_max_abs(par_arrays(r, "avg1/param/"), mine[0])
                 for r in ra]}
        log(f"(d) replica averaging: {json.dumps(d)}")
        if max(d["avg_all_vs_mean"] + d["avg_alive_1_0_vs_replica_0"]) \
                > REPLICA_ATOL:
            raise AssertionError(f"(d) replica averaging: {d}")
        rec["d"] = d
        by_path("replica_train", ra)

        # (e) the CLI through the launcher
        expdir, report = work / "cli", work / "cli_report"
        t = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-m", "css_tpu_torch.parallel.launch",
             "--num-processes", "2", "--timeout", str(2 * PAR_TIMEOUT_S),
             "--", *PAR_CLI_ARGS, "--expdir", str(expdir), "--rank-report",
             str(report), "--device", dev.type],
            capture_output=True, text=True, timeout=3 * PAR_TIMEOUT_S)
        cli_s = time.perf_counter() - t
        if res.returncode != 0:
            raise AssertionError(f"(e) launcher rc {res.returncode}:\n"
                                 f"{res.stdout[-3000:]}{res.stderr[-3000:]}")
        reports = [json.loads((report / f"rank{r}.json").read_text())
                   for r in range(2)]
        n_train = PAR_CLI_EPOCHS * PAR_CLI_BATCHES
        files = sorted(["conf.1.json", "train.1.jsonl"]
                       + [f"{e + 1}.1.mdl" for e in range(PAR_CLI_EPOCHS)])
        for r in reports:
            k3 = n_train + (PAR_CLI_EPOCHS * PAR_CLI_VALID
                            if r["rank"] == 0 else 0)
            want = {"stft_mag": k3, "istft": 0, "lstm_fused": 0}
            if (r["launches"] != want or any(r["plain_routes"].values())
                    or not np.isfinite(r["epoch_losses"]).all()
                    or r["in_sync"] is not True
                    or r["backend"] != "gloo"):
                raise AssertionError(f"(e) rank {r['rank']}: {r}")
        if (sorted(reports[0]["written"]) != files or reports[1]["written"]
                or reports[0]["state_digest"] != reports[1]["state_digest"]):
            raise AssertionError(f"(e) writes or digests: {reports}")
        load_checkpoint(str(expdir / f"{PAR_CLI_EPOCHS}.1.mdl"))
        by_path("dp_train", reports)
        rec["e"] = {"seconds": cli_s,
                    "epoch_losses": reports[0]["epoch_losses"],
                    "launches": [r["launches"] for r in reports]}
        log(f"(e) cli dp world 2: {json.dumps(rec['e'])}")

        # (f) the driver: elastic, then abort
        f = {}
        for mode in ("elastic", "abort"):
            d_exp = work / f"driver_{mode}"
            t = time.perf_counter()
            res = subprocess.run(
                [sys.executable, "-m", "css_tpu_torch.cli.train_parallel",
                 "--expdir", str(d_exp), "--num-epochs", "2", "--nj-init",
                 "2", "--nj-final", "2", "--retry", "1", "--inject-failure",
                 "1.2", "--on-failure", mode, "--", *DRIVER_ARGS,
                 "--device", dev.type],
                capture_output=True, text=True, timeout=2 * PAR_TIMEOUT_S)
            f[mode] = {"rc": res.returncode,
                       "seconds": time.perf_counter() - t}
            sentinel = (d_exp / ".error.1.2").exists()
            if mode == "elastic":
                ok = (res.returncode == 0 and sentinel
                      and (d_exp / "2.mdl").exists()
                      and load_checkpoint(str(d_exp / "2.mdl"))["epoch"] == 2)
            else:
                ok = (res.returncode != 0 and sentinel
                      and not (d_exp / "1.mdl").exists())
            if not ok:
                raise AssertionError(f"(f) driver {mode}: rc "
                                     f"{res.returncode}, sentinel {sentinel}"
                                     f"\n{res.stderr[-3000:]}")
        rec["f"] = f
        log(f"(f) driver: {json.dumps(f)}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return rec


def sharded_path(torch, dev, results, counters, mix) -> dict:
    """Phase 9 (g): sharded separation in this process, launch counts set
    to 0 just before and read just after each run."""
    from css_tpu_torch.cli.separate import load_model
    from css_tpu_torch.executor.pipeline import CssPipeline
    from css_tpu_torch.executor.windowing import pad_for_windows
    from css_tpu_torch.models import blstm

    sharded_cfg = dict(CONFIG, separation=dict(CONFIG["separation"],
                                               sharded=True))
    shards = [dev, dev]
    per_shard = -(-main_shapes()["n_windows"] // len(shards))
    shard_batches = len(shards) * -(-per_shard
                                    // CONFIG["separation"]["batch_size"])
    g = {}
    for name in ("conformer", "blstm"):
        if name == "conformer":
            model = load_model(CHECKPOINT)
            model.compute_dtype = torch.float32
        else:
            model = blstm.BLSTM.build_model({})
            model.load_state_dict(blstm.params_from_jax(
                blstm.init_params(BLSTM_SEED, {})))
        plain = CssPipeline(model, CONFIG, device=dev)
        pipe = CssPipeline(model, sharded_cfg, device=dev,
                           shard_devices=shards)
        n_dirs = 2 * len(model.encoders) if name == "blstm" else 0
        expect = {"stft_mag": shard_batches, "istft": 1,
                  "lstm_fused": shard_batches * n_dirs}
        secs = {}
        for label, p in (("unsharded", plain), ("sharded", pipe)):
            for _ in range(2):  # cold, then warm
                for c in counters:
                    c.launches = c.plain_routes = 0
                t = time.perf_counter()
                outs = p.process(mix)
                secs[label] = time.perf_counter() - t
                counts = {c.__name__: c.launches for c in counters}
                routes = {c.__name__: c.plain_routes for c in counters}
            if label == "sharded":
                if counts != expect or any(routes.values()):
                    raise AssertionError(
                        f"(g) sharded {name}: launches {counts} (expected "
                        f"{expect}), plain routes {routes}")
                for r in results:
                    r["launches_by_path"][f"sharded_{name}"] = \
                        counts[r["name"]]
                sharded_outs = outs
            else:
                plain_outs = outs
        wav = pad_for_windows(torch.as_tensor(mix, device=dev),
                              plain.separator.win, plain.separator.hop)
        with torch.no_grad():
            m_plain, _ = plain.separator.separate(wav)
            _, m_shard, _ = pipe.sharded.separate(wav)
        mask_err = float((m_shard - m_plain).abs().max())
        stream_err = max(float(np.abs(a - b).max())
                         for a, b in zip(sharded_outs, plain_outs))
        g[name] = {"mask_max_abs": mask_err, "stream_max_abs": stream_err,
                   "sharded_s": secs["sharded"],
                   "unsharded_s": secs["unsharded"], "launches": counts}
        log(f"(g) sharded {name}: {json.dumps(g[name])}")
        if mask_err > SHARD_MASK_ATOL or stream_err > SHARD_STREAM_ATOL:
            raise AssertionError(f"(g) sharded {name}: masks {mask_err:.3e} "
                                 f"(atol {SHARD_MASK_ATOL}), streams "
                                 f"{stream_err:.3e} (atol "
                                 f"{SHARD_STREAM_ATOL})")
        del model, plain, pipe
    return g

def export_artifact(torch, model, dev, path) -> dict:
    """cli.export's export_forward at the separator batch's shape on the
    card, saved to ``path`` and loaded back: seconds to export, bytes,
    seconds to load, and the graph's port ops and sigmoid/tanh nodes (an
    unrolled recurrence)."""
    from css_tpu_torch.cli import export

    m = main_shapes()
    t = time.perf_counter()
    program = export.export_forward(model, m["batch"], m["n_frames"],
                                    m["frame"] // 2 + 1, dev)
    export_s = time.perf_counter() - t
    torch.export.save(program, path)
    t = time.perf_counter()
    export.load_exported(path)
    load_s = time.perf_counter() - t
    targets = [str(n.target) for n in program.graph.nodes
               if n.op == "call_function"]
    return {"export_s": export_s, "bytes": path.stat().st_size,
            "load_s": load_s, "graph_nodes": len(program.graph.nodes),
            "port_ops": [t for t in targets if t.startswith("css_tpu_torch.")],
            "sigmoid_tanh_nodes": sum("sigmoid" in t or "tanh" in t
                                      for t in targets)}


def served_separator(path, dev):
    """A Separator serving the artifact at ``path`` under CONFIG."""
    from css_tpu_torch.executor.separator import Separator

    sep = CONFIG["separation"]
    return Separator(None, exported_path=str(path),
                     sr=CONFIG["sampling_rate"], eval_win=sep["eval_win"],
                     eval_hop=sep["eval_hop"], frame_len=sep["frame_length"],
                     frame_hop=sep["frame_shift"],
                     batch_size=sep["batch_size"], device=dev)


def serve_path(torch, dev, results, run, mix, work) -> dict:
    """Phase 10 (a)-(b): export the flagship and the full-width BLSTM,
    serve each artifact against its live model on the session."""
    from css_tpu_torch.cli.separate import load_model
    from css_tpu_torch.executor.pipeline import CssPipeline
    from css_tpu_torch.executor.windowing import pad_for_windows
    from css_tpu_torch.models import blstm

    n_batches = -(-main_shapes()["n_windows"] // main_shapes()["batch"])
    out = {}
    for name in ("conformer", "blstm"):
        if name == "conformer":
            model = load_model(CHECKPOINT)  # its own bf16 compute
            atol = SERVE_FLAGSHIP_ATOL
        else:
            model = blstm.BLSTM.build_model({})  # 1024 x 3, float32
            model.load_state_dict(blstm.params_from_jax(
                blstm.init_params(BLSTM_SEED, {})))
            atol = SERVE_BLSTM_ATOL
        live = CssPipeline(model, CONFIG, device=dev)
        art = export_artifact(torch, live.model, dev, work / f"{name}.pt2")
        n_k2 = 2 * len(model.encoders) if name == "blstm" else 0
        log(f"(a) export {name}: {json.dumps(art)}")
        if name == "blstm" and (art["port_ops"] != [
                "css_tpu_torch.lstm_fused.default"] * n_k2
                or art["sigmoid_tanh_nodes"]):
            raise AssertionError(
                f"(a) the BLSTM's graph: {art['port_ops']} and "
                f"{art['sigmoid_tanh_nodes']} sigmoid/tanh nodes, expected "
                f"{n_k2} K2 op nodes and no unrolled loop")
        if name == "conformer" and art["port_ops"]:
            raise AssertionError(f"(a) the Conformer's graph holds ops of "
                                 f"the port: {art['port_ops']}")
        served = CssPipeline(model, CONFIG, device=dev)
        served.separator = served_separator(work / f"{name}.pt2", dev)
        wav = pad_for_windows(torch.as_tensor(mix, device=dev),
                              live.separator.win, live.separator.hop)
        masks_live, mags_live = live.separator.separate(wav)
        masks_served, mags_served = served.separator.separate(wav)
        mask_gap = float((masks_served - masks_live).abs().max())
        mags_gap = float((mags_served - mags_live).abs().max())
        del masks_live, mags_live, masks_served, mags_served
        expect = {"stft_mag": n_batches, "istft": 1,
                  "lstm_fused": n_batches * n_k2}
        secs = {}
        for label, pipe in (("live", live), ("served", served)):
            run(pipe, mix, f"{name} {label} (cold)", expect)
            times = []
            for _ in range(SERVE_REPS):
                outs, counts, sec = run(pipe, mix, f"{name} {label}", expect)
                times.append(sec)
            secs[label] = float(np.median(times))
            if label == "served":
                for r in results:
                    r["launches_by_path"][f"served_{name}"] = \
                        counts[r["name"]]
                served_outs = outs
            else:
                live_outs = outs
        stream_gap = max(float(np.abs(a - b).max())
                         for a, b in zip(served_outs, live_outs))
        out[name] = {**art, "mask_max_abs": mask_gap,
                     "mag_max_abs": mags_gap, "stream_max_abs": stream_gap,
                     "served_s_median": secs["served"],
                     "live_s_median": secs["live"], "launches": counts,
                     "compute_dtype": str(model.compute_dtype)[6:]}
        log(f"(b) served {name}: {json.dumps(out[name])}")
        if mask_gap > atol or (name == "blstm" and mags_gap > atol):
            raise AssertionError(
                f"(b) served {name} against live: masks {mask_gap:.3e}, "
                f"magnitudes {mags_gap:.3e} (atol {atol})")
        del model, live, served
    return out


def import_path(torch, dev, mix, work) -> dict:
    """Phase 10 (c): the flagship's weights as a reference torch
    checkpoint, through ``python -m css_tpu_torch.cli.import_torch``; the
    imported checkpoint's float32 masks on the session against the
    flagship's."""
    from css_tpu_torch.cli.separate import load_model
    from css_tpu_torch.executor.pipeline import CssPipeline
    from css_tpu_torch.models import build_model, state_dict_from_checkpoint
    from css_tpu_torch.trainer.checkpoint import load_checkpoint

    ckpt = load_checkpoint(CHECKPOINT)
    conf = dict(ckpt["conf"])
    ref = work / "reference.mdl"
    torch.save({"model": reference_state_dict(torch, ckpt["params"],
                                              ckpt["batch_stats"]),
                "epoch": int(ckpt["epoch"]), "loss": float(ckpt["loss"]),
                "objective": {}, "optimizer": {}, "lr_sched": {}}, ref)
    dst = work / "imported.mdl"
    t = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "css_tpu_torch.cli.import_torch", str(ref),
         str(dst), "--model", "Conformer", "--num-blocks",
         str(conf["conformer_num_blocks"])],
        cwd=REPO_ROOT, capture_output=True, text=True, timeout=300)
    import_s = time.perf_counter() - t
    if res.returncode != 0:
        raise AssertionError(f"(c) cli.import_torch failed: "
                             f"{res.stderr[-2000:]}")
    imported = load_checkpoint(dst)
    if (imported["epoch"], imported["loss"]) != (ckpt["epoch"], ckpt["loss"]):
        raise AssertionError("(c) the import lost the epoch or the loss")
    flagship = load_model(CHECKPOINT)
    flagship.compute_dtype = torch.float32
    want = separator_masks(torch, CssPipeline(flagship, CONFIG, device=dev),
                           mix, dev)
    # the import keeps the weights, not the training conf: the flagship's
    # widths in float32
    model = build_model("Conformer", dict(conf, bf16=False))
    model.load_state_dict(state_dict_from_checkpoint("Conformer", imported))
    got = separator_masks(torch, CssPipeline(model, CONFIG, device=dev),
                          mix, dev)
    gap = float((got - want).abs().max())
    rec = {"import_s": import_s, "reference_bytes": ref.stat().st_size,
           "mask_max_abs": gap, "compute_dtype": "float32"}
    log(f"(c) import: {json.dumps(rec)}")
    if gap > IMPORT_ATOL:
        raise AssertionError(f"(c) imported masks against the flagship's: "
                             f"{gap:.3e} (atol {IMPORT_ATOL})")
    return rec


def libricss_tree(root, refs, mixes):
    """TOOLS_SESSIONS synthetic two-talker sessions in the LibriCSS release
    layout (record/raw_recording.wav, transcription/meeting_info.txt with
    one row per speaker: its utterances' pitch tokens in turn order), their
    sources as {key}_src{i}.wav and mixtures as {key}.wav. Returns the
    keys."""
    from css_tpu_torch.data.corpus import SyntheticCorpus
    from css_tpu_torch.data.sessions import make_session
    from css_tpu_torch.data.wav_io import write_wav

    corpus = SyntheticCorpus(**PROBE_CORPUS)
    conds = ["OV10", "0L", "OV20", "0S"]
    keys = []
    for i in range(TOOLS_SESSIONS):
        mix, srcs, spoken = make_session(
            corpus, np.random.default_rng(TOOLS_SEED + i), TOOLS_SESSION_SEC,
            with_info=True)
        d = (root / conds[i] /
             f"overlap_ratio_10.0_sil0.1_1.0_session{i}_actual10.0")
        (d / "record").mkdir(parents=True)
        (d / "transcription").mkdir()
        write_wav(d / "record" / "raw_recording.wav", mix)
        rows = [" ".join(u.text for u in spoken[k::2] if u.text)
                for k in range(2)]
        (d / "transcription" / "meeting_info.txt").write_text(
            "start\tend\tspeaker\tutterance_id\ttranscription\n" + "".join(
                f"0.0\t{TOOLS_SESSION_SEC}\tspk{k}\tutt{k}\t{text}\n"
                for k, text in enumerate(rows)))
        key = f"session{i}_{conds[i]}"
        keys.append(key)
        write_wav(mixes / f"{key}.wav", mix)
        for k, src in enumerate(srcs):
            write_wav(refs / f"{key}_src{k}.wav", src)
    return keys


def check_recipe_launches(logs, keys) -> dict:
    """Each cli.separate process of the recipe (one a session) logs its
    kernel launches: K3 once a separator batch, K1 once, no K2 (the
    flagship), no plain route. Returns their sums."""
    want = {"stft_mag": -(-windows_of(TOOLS_SESSION_SEC)
                          // main_shapes()["batch"]),
            "istft": 1, "lstm_fused": 0}
    if len(logs) != len(keys):
        raise AssertionError(f"(d) {len(logs)} cli.separate launch records "
                             f"for {len(keys)} sessions")
    total = dict.fromkeys(want, 0)
    for rec in logs:
        if rec["launches"] != want or any(rec["plain_routes"].values()):
            raise AssertionError(f"(d) cli.separate: {rec}, expected "
                                 f"launches {want} and no plain route")
        for k in total:
            total[k] += rec["launches"][k]
    return total


def tools_path(torch, dev, results, work) -> dict:
    """Phase 10 (d): recipes/separate_libricss_torch.sh (prepare ->
    cli.separate --config configs/infer_1ch.yaml -> cli.wer with the toy
    ASR) on the card, then cli.evaluate on its streams."""
    from css_tpu_torch.data.wav_io import read_wav
    from css_tpu_torch.utils.metrics import pit_si_snr_db

    root, refs, mixes, out = (work / d for d in ("for_release", "refs",
                                                 "mixes", "separated"))
    for d in (refs, mixes):
        d.mkdir(parents=True)
    keys = libricss_tree(root, refs, mixes)
    env = dict(os.environ, device=dev.type, model="Conformer",
               SESSIONS=" ".join(k.split("_")[0] for k in keys),
               ASR_CMD=f"{sys.executable} -m css_tpu_torch.cli.toy_asr {{wav}}")
    t = time.perf_counter()
    res = subprocess.run(
        ["bash", "recipes/separate_libricss_torch.sh", str(root), CHECKPOINT,
         str(out)], cwd=REPO_ROOT, env=env, capture_output=True, text=True,
        timeout=TOOLS_TIMEOUT_S)
    recipe_s = time.perf_counter() - t
    if res.returncode != 0:
        raise AssertionError(f"(d) the recipe failed (rc {res.returncode}):"
                             f" {res.stderr[-3000:]}")
    stages = {m.group(1): float(m.group(2)) for m in re.finditer(
        r"^stage (\w+): ([0-9.]+) s$", res.stdout, re.M)}
    logs = [json.loads(m.group(1)) for m in re.finditer(
        r"kernel launches (\{.*\})$", res.stderr, re.M)]
    launches = check_recipe_launches(logs, keys)
    for r in results:
        r["launches_by_path"]["libricss_recipe"] = launches[r["name"]]
    summary = [json.loads(line) for line in open(out / "wer.jsonl")][-1]
    if (sorted(stages) != ["prepare", "separate", "wer"]
            or summary["num_recordings"] != len(keys)
            or not summary["ref_words"] or not np.isfinite(summary["wer"])):
        raise AssertionError(f"(d) stages {stages}, wer summary {summary}")
    t = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "css_tpu_torch.cli.evaluate", "--estimates",
         str(out), "--references", str(refs), "--mixtures", str(mixes),
         "--output", str(work / "eval.jsonl")], cwd=REPO_ROOT,
        capture_output=True, text=True, timeout=300)
    evaluate_s = time.perf_counter() - t
    if res.returncode != 0:
        raise AssertionError(f"(d) cli.evaluate failed: {res.stderr[-2000:]}")
    evals = [json.loads(line) for line in open(work / "eval.jsonl")]
    gaps = []
    for rec in evals[:-1]:
        k = rec["num_spk"]
        ests = [read_wav(out / f"{rec['key']}_{i}.wav")[0] for i in range(k)]
        srcs = [read_wav(refs / f"{rec['key']}_src{i}.wav")[0]
                for i in range(k)]
        gaps.append(abs(rec["si_snr_db"] - pit_si_snr_db(ests, srcs)))
    rec = {"sessions": len(keys), "session_s": TOOLS_SESSION_SEC,
           "stages_s": stages, "recipe_s": recipe_s,
           "evaluate_s": evaluate_s, "wer": summary, "launches": launches,
           "mean_si_snr_db": evals[-1]["mean_si_snr_db"],
           "mean_si_snri_db": evals[-1]["mean_si_snri_db"],
           "si_snr_gap_db": max(gaps)}
    log(f"(d) tools: {json.dumps(rec)}")
    if len(evals) != len(keys) + 1 or max(gaps) > EVAL_ATOL_DB:
        raise AssertionError(f"(d) cli.evaluate against pit_si_snr_db: "
                             f"{gaps} dB (atol {EVAL_ATOL_DB})")
    return rec


def export_serve_path(torch, dev, results, run, mix) -> dict:
    """Phase 10: (a)-(b) serve_path, (c) import_path, (d) tools_path, in a
    work directory removed at the end."""
    import shutil
    import tempfile
    from pathlib import Path

    if dev.type == "cuda":
        torch.cuda.empty_cache()
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_tools_"))
    try:
        rec = {"serve": serve_path(torch, dev, results, run, mix, work)}
        rec["import"] = import_path(torch, dev, mix, work)
        rec["tools"] = tools_path(torch, dev, results, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return rec


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        log("chip_smoke: torch.cuda.is_available() is False; nothing run")
        return 1

    from css_tpu_torch.cli.separate import load_model
    from css_tpu_torch.executor.pipeline import CssPipeline
    from css_tpu_torch.models import blstm
    from css_tpu_torch.executor.reanchor import reanchor_streams
    from css_tpu_torch.ops import (_build, istft_cuda, lstm_cuda, native,
                                   stft_mag_cuda)
    from css_tpu_torch.ops import stft as stft_ops

    # ---------------------------------------------------------- 1. device
    t0 = time.perf_counter()
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    smi_line = smi.stdout.strip().splitlines()[0]
    log(f"device: {kind} x{count}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}; {smi_line}")
    t_build = time.perf_counter()
    lib_path = _build.build()
    _build.load_library()
    log(f"built {lib_path.name} in {time.perf_counter() - t_build:.1f} s")
    log(lib_path.with_suffix(".log").read_text())
    # the native mixing core, built by g++ at this first use; its
    # fall-backs to numpy are counted from here to the end of the run
    t_build = time.perf_counter()
    if native.load() is None:
        raise AssertionError(f"native core unavailable: {native.error}")
    native.fallbacks = 0
    log(f"built {native.library_path().name} in "
        f"{time.perf_counter() - t_build:.1f} s")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase("device+build", t0)

    # --------------------------------------------------------- 2. kernels
    t0 = time.perf_counter()
    shapes = main_shapes()
    frame, hop = shapes["frame"], shapes["hop"]
    sr = CONFIG["sampling_rate"]
    batch = shapes["batch"]
    # windows that cover the session (73 for 60 s at the 0.8 s hop)
    n_windows = shapes["n_windows"]
    bins = frame // 2 + 1
    results = []

    # K3 on one separator batch of windows
    x = stft_input(torch, dev)
    got = counted(stft_mag_cuda.stft_mag, 1, "stft_mag",
                  lambda: stft_mag_cuda.stft_mag(x, frame, hop))
    want = stft_mag_cuda.stft_mag_plain(x, frame, hop)
    torch.cuda.synchronize()
    err3 = check_close("stft_mag", got, want, KERNEL_ATOL, KERNEL_RTOL)
    n_frames = got.shape[1]
    hann = torch.hann_window(frame, device=dev)

    def lib_fn():
        return torch.stft(x, frame, hop, window=hann, center=False,
                          return_complex=True).abs()

    lib_err = float((lib_fn().transpose(1, 2) - want).abs().max())
    ms3 = time_ms(torch, lambda: stft_mag_cuda.stft_mag(x, frame, hop))
    plain3 = time_ms(torch, lambda: stft_mag_cuda.stft_mag_plain(x, frame, hop))
    lib3 = time_ms(torch, lib_fn)
    dev3 = device_ms(torch, lambda: stft_mag_cuda.stft_mag(x, frame, hop))
    lib_dev3 = device_ms(torch, lib_fn)
    # the function's least work: per frame a window multiply, a real FFT
    # and |.| of every bin; the signal read once, the magnitudes written
    # once
    b3, by3 = bound_ms(
        batch * n_frames * (frame + rfft_flops(frame) + 4 * bins),
        4.0 * (x.numel() + got.numel()))
    log(f"K3 stft_mag {tuple(x.shape)}: max_abs_err {err3:.3e} (torch.stft "
        f"{lib_err:.3e}); kernel_ms {ms3:.4f} plain_ms {plain3:.4f} "
        f"library_ms {lib3:.4f} bound_ms {b3:.4f} ({by3}); device time: "
        f"kernel {dev3} ms, library {lib_dev3} ms")
    results.append({
        "name": "stft_mag", "route": "cuda",
        "source": "css_tpu_torch/csrc/stft_mag.cu",
        "replaces": "css_tpu/ops/_stft_pallas_r01.py:74",
        "launches": None, "max_abs_err": err3, "ms": ms3, "plain_ms": plain3,
        "bound_ms": b3, "bound_by": by3, "library_ms": lib3,
        "device_ms": dev3, "library_device_ms": lib_dev3})

    # K1 on every masked stream of a 60 s recording: 2 x 73 rows
    spec = istft_input(torch, dev)
    rows = spec.shape[0]
    got = counted(istft_cuda.istft, 1, "istft",
                  lambda: istft_cuda.istft(spec, frame, hop))
    want = istft_cuda.istft_plain(spec, frame, hop)
    torch.cuda.synchronize()
    err1 = check_close("istft", got, want, KERNEL_ATOL, KERNEL_RTOL)
    ms1 = time_ms(torch, lambda: istft_cuda.istft(spec, frame, hop))
    dev1 = device_ms(torch, lambda: istft_cuda.istft(spec, frame, hop))
    plain1 = time_ms(torch, lambda: istft_cuda.istft_plain(spec, frame, hop))
    # least work: per frame an inverse real FFT and a window multiply, per
    # sample an overlap add and the envelope multiply; the spectrum read
    # once, the signal written once
    b1, by1 = bound_ms(
        rows * n_frames * (frame + rfft_flops(frame)) + 2.0 * got.numel(),
        8.0 * spec.numel() + 4.0 * got.numel())
    # torch.istft(center=False) refuses the periodic Hann window (its
    # envelope is 0 at the first sample: the NOLA check fails), so K1 has
    # no one-call library counterpart
    log(f"K1 istft {tuple(spec.shape)}: max_abs_err {err1:.3e}; kernel_ms "
        f"{ms1:.4f} plain_ms {plain1:.4f} bound_ms {b1:.4f} ({by1}); "
        f"device time {dev1} ms")
    # K1 through its centered entry on the 7ch path's beamformed spectra:
    # 2 x 73 rows of n_frames + 2 centered frames, trimmed to the window
    spec_c = istft_centered_input(torch, dev)
    win = shapes["win"]
    got = counted(istft_cuda.istft, 1, "istft_centered",
                  lambda: istft_cuda.istft_centered(spec_c, frame, hop, win))
    want = stft_ops.istft(spec_c, frame, hop, center=True, length=win)
    torch.cuda.synchronize()
    err1c = check_close("istft_centered", got, want, KERNEL_ATOL, KERNEL_RTOL)
    ms1c = time_ms(torch, lambda: istft_cuda.istft_centered(spec_c, frame,
                                                            hop, win))
    dev1c = device_ms(torch, lambda: istft_cuda.istft_centered(
        spec_c, frame, hop, win))
    plain1c = time_ms(torch, lambda: stft_ops.istft(
        spec_c, frame, hop, center=True, length=win))
    # the same least work as above on T + 2 frames, the trimmed signal
    # written once
    t_c = spec_c.shape[1]
    b1c, by1c = bound_ms(
        rows * t_c * (frame + rfft_flops(frame))
        + 2.0 * rows * (t_c + 1) * hop,
        8.0 * spec_c.numel() + 4.0 * got.numel())
    # centered, torch.istft takes the window: inside the trim the squared
    # Hann envelope is >= 0.5, so it normalises as the plain version does

    def lib1c():
        return torch.istft(spec_c.transpose(1, 2), frame, hop, window=hann,
                           center=True, length=win)

    lib_err1c = float((lib1c() - want).abs().max())
    lib1c_ms = time_ms(torch, lib1c)
    log(f"K1 istft_centered {tuple(spec_c.shape)}: max_abs_err {err1c:.3e} "
        f"(torch.istft {lib_err1c:.3e}); kernel_ms {ms1c:.4f} plain_ms "
        f"{plain1c:.4f} library_ms {lib1c_ms:.4f} bound_ms {b1c:.4f} "
        f"({by1c}); device time {dev1c} ms")
    results.append({
        "name": "istft", "route": "cuda",
        "source": "css_tpu_torch/csrc/istft.cu",
        "replaces": "css_tpu/ops/istft_pallas.py:87",
        "launches": None, "max_abs_err": max(err1, err1c), "ms": ms1,
        "plain_ms": plain1, "bound_ms": b1, "bound_by": by1,
        "library_ms": None, "device_ms": dev1,
        "centered": {"shape": list(spec_c.shape), "max_abs_err": err1c,
                     "ms": ms1c, "plain_ms": plain1c, "bound_ms": b1c,
                     "bound_by": by1c, "library_ms": lib1c_ms,
                     "device_ms": dev1c}})
    del x, spec, got, want, spec_c

    # K2 on one LSTM direction of a separator batch: the BLSTM's hidden 512
    # per direction and the causal BLSTM's hidden 1024, each in float32 and
    # bf16, forward and reverse, on a layer's inputs (lstm_layer_inputs)
    lstm_cases = []
    lib2 = None
    tf32_controls = {}
    for hidden in (512, 1024):
        x, w_ih, bias, w_hh32, xw32 = lstm_layer_inputs(torch, dev, hidden)
        for dtype, elem in ((torch.float32, 4), (torch.bfloat16, 2)):
            xw, w_hh = xw32.to(dtype), w_hh32.to(dtype)
            for reverse in (False, True):
                label = (f"lstm_fused h{hidden} {str(dtype)[6:]} "
                         f"{'rev' if reverse else 'fwd'}")
                got = counted(lstm_cuda.lstm_fused, 1, label,
                              lambda: lstm_cuda.lstm_fused(xw, w_hh, hidden,
                                                           reverse))
                want = lstm_cuda.lstm_plain(xw, w_hh, hidden, reverse)
                torch.cuda.synchronize()
                flops, nbytes = lstm_work(batch, n_frames, hidden, elem)
                if dtype == torch.float32:
                    err = check_close(label, got, want, KERNEL_ATOL,
                                      KERNEL_RTOL)
                    if err > LSTM_F32_MAX_ERR:
                        raise AssertionError(
                            f"{label}: max abs err {err:.3e} > "
                            f"{LSTM_F32_MAX_ERR} (3xTF32's bound)")
                    bnd, by = bound_ms(flops, nbytes, PEAK_3XTF32_FLOPS)
                else:
                    err = check_close(label, got.float(), want.float(),
                                      LSTM_BF16_ATOL, 0.0)
                    bnd, by = bound_ms(flops, nbytes, PEAK_BF16_FLOPS)
                ms = time_ms(torch, lambda: lstm_cuda.lstm_fused(
                    xw, w_hh, hidden, reverse))
                plain = time_ms(torch, lambda: lstm_cuda.lstm_plain(
                    xw, w_hh, hidden, reverse))
                case = {"hidden": hidden, "dtype": str(dtype)[6:],
                        "reverse": reverse, "shape": list(xw.shape),
                        "max_abs_err": err, "ms": ms, "plain_ms": plain,
                        "bound_ms": bnd, "bound_by": by}
                if dtype == torch.float32:
                    case["bound_fp32_cores_ms"] = bound_ms(flops, nbytes)[0]
                log(f"K2 {label} {tuple(xw.shape)}: max_abs_err {err:.3e}; "
                    f"kernel_ms {ms:.4f} plain_ms {plain:.4f} bound_ms "
                    f"{bnd:.4f} ({by})")
                lstm_cases.append(case)
        # the control: the same function with its product in single TF32
        # must fail the tight float32 bound
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            ctrl = lstm_cuda.lstm_plain(xw32, w_hh32, hidden)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        ctrl_err = float((ctrl - lstm_cuda.lstm_plain(xw32, w_hh32, hidden))
                         .abs().max())
        tf32_controls[hidden] = ctrl_err
        log(f"K2 control h{hidden}: single-TF32 plain version vs plain, max "
            f"abs err {ctrl_err:.3e} (must exceed {LSTM_F32_MAX_ERR})")
        if not ctrl_err > LSTM_F32_MAX_ERR:
            raise AssertionError(
                f"K2 h{hidden}: a single-TF32 product passes the float32 "
                f"bound {LSTM_F32_MAX_ERR} (max abs err {ctrl_err:.3e})")
        if hidden == 512:
            # the yardstick: cuDNN's LSTM (one layer, one direction, float32)
            # on the layer's input x, so it includes the input projection
            # x @ W_ih^T that the kernel is handed precomputed
            ref = torch.nn.LSTM(1024, hidden, batch_first=True).to(dev)
            with torch.no_grad():
                ref.weight_ih_l0.copy_(w_ih)
                ref.weight_hh_l0.copy_(w_hh32.t())
                ref.bias_ih_l0.copy_(bias)
                ref.bias_hh_l0.zero_()

                def lib_lstm():
                    return ref(x)[0]

                lib_err = float((lib_lstm() - lstm_cuda.lstm_plain(
                    xw32, w_hh32, hidden)).abs().max())
                lib2 = time_ms(torch, lib_lstm)
            log(f"K2 library: torch.nn.LSTM (cuDNN, float32, includes the "
                f"input projection) {lib2:.4f} ms; max abs diff from the "
                f"plain version {lib_err:.3e}")
            del ref
        del x, w_ih, w_hh32, xw32, xw, w_hh, got, want, ctrl
    print("lstm_cases " + json.dumps(lstm_cases), flush=True)
    print("lstm_tf32_control " + json.dumps({
        "bound": LSTM_F32_MAX_ERR,
        "kernel_max_abs_err": max(c["max_abs_err"] for c in lstm_cases
                                  if c["dtype"] == "float32"),
        "single_tf32_max_abs_err": tf32_controls}), flush=True)
    # K2's phase split at the main shape, forward: where a step's cycles go
    # (thread 0 of each block, averaged over blocks and steps); the
    # product plus gates is the sum of the last two phases
    _, _, _, w_hh32, xw32 = lstm_layer_inputs(torch, dev, 512)
    for dtype in (torch.float32, torch.bfloat16):
        xw, w_hh = xw32.to(dtype), w_hh32.to(dtype)
        split = lstm_cuda.phase_split(xw, w_hh, 512)
        step_cycles = sum(split.values())
        print("lstm_phases " + json.dumps({
            "shape": list(xw.shape), "dtype": str(dtype)[6:],
            "cycles_per_step": split,
            "product_plus_gates": split["product"] + split["gates"],
            "share": {k: v / step_cycles for k, v in split.items()}}),
            flush=True)
    dev2 = device_ms(torch, lambda: lstm_cuda.lstm_fused(xw32, w_hh32, 512))
    del xw, w_hh, xw32, w_hh32
    # K2 with a carried state at the hop path's chunk (phase 8's shape)
    k2_stream = k2_stream_record(torch, lstm_cuda, dev)
    main2 = lstm_cases[0]  # hidden 512, float32, forward: the BLSTM's
    results.append({
        "name": "lstm_fused", "route": "cuda",
        "source": "css_tpu_torch/csrc/lstm.cu",
        "replaces": "css_tpu/ops/lstm_pallas.py:103",
        "launches": None, "max_abs_err": max(
            [c["max_abs_err"] for c in lstm_cases if c["dtype"] == "float32"]
            + [k2_stream["max_abs_err"]]),
        "ms": main2["ms"], "plain_ms": main2["plain_ms"],
        "bound_ms": main2["bound_ms"], "bound_by": main2["bound_by"],
        "library_ms": lib2, "device_ms": dev2,
        "stream": dict(k2_stream, launches="3 per chunk (one per layer) on "
                       "the hop path's causal BLSTM")})
    phase("kernels", t0)

    counters = (stft_mag_cuda.stft_mag, istft_cuda.istft,
                lstm_cuda.lstm_fused)
    n_batches = -(-n_windows // batch)

    def run(pipe, mix, label, expect):
        """One call of the main path, launch and plain-route counts reset
        just before it and read just after; expect=None (the plain run)
        skips both checks."""
        for c in counters:
            c.launches = 0
            c.plain_routes = 0
        t = time.perf_counter()
        outs = pipe.process(mix)  # ends with a device-to-host copy
        sec = time.perf_counter() - t
        counts = {c.__name__: c.launches for c in counters}
        routes = {c.__name__: c.plain_routes for c in counters}
        if expect is not None and counts != expect:
            raise AssertionError(f"run {label}: launches {counts}, "
                                 f"expected {expect}")
        if expect is not None and any(routes.values()):
            raise AssertionError(f"run {label}: plain routes taken {routes}")
        if len(outs) != 2:
            raise AssertionError(f"run {label}: {len(outs)} streams")
        for o in outs:
            if o.shape != mix.shape[-1:] or not np.isfinite(o).all():
                raise AssertionError(f"run {label}: bad stream {o.shape}")
            if abs(float(np.abs(o).max()) - 0.9) > 1e-4:
                raise AssertionError(f"run {label}: peak {np.abs(o).max()}")
        log(f"run {label}: {sec:.3f} s, {SESSION_SEC / sec:.1f} audio-sec/s, "
            f"launches {counts}, plain routes {routes}")
        return outs, counts, sec

    def plain_run(pipe, mix, label):
        with plain_kernels(stft_mag_cuda, istft_cuda, lstm_cuda):
            outs, counts, sec = run(pipe, mix, label, None)
        if any(counts.values()):
            raise AssertionError(f"plain run launched kernels: {counts}")
        return outs, sec

    # ------------------------------------------------- 3. Conformer path
    t0 = time.perf_counter()
    model = load_model(CHECKPOINT)
    if model.compute_dtype != torch.bfloat16:
        raise AssertionError("the flagship's conf should select bf16")
    mix, srcs = synthetic_session(SESSION_SEC, CONFIG["sampling_rate"], SEED)
    pipe = CssPipeline(model, CONFIG, device="cuda")
    phase("load", t0)
    expect = {"stft_mag": n_batches, "istft": 1, "lstm_fused": 0}

    out_a, counts_a, cold_a = run(pipe, mix, "a bf16 (cold)", expect)
    _, _, warm_a = run(pipe, mix, "a bf16 (warm)", expect)
    for r in results:
        if r["name"] != "lstm_fused":
            r["launches"] = counts_a[r["name"]]
        # each path's own run, counts set to 0 just before it
        r["launches_by_path"] = {"conformer": counts_a[r["name"]]}
    stages = stage_seconds(torch, pipe, mix, dev)
    print("stages_s " + json.dumps({"path": "conformer bf16", **stages}),
          flush=True)

    model.compute_dtype = torch.float32
    out_b, _, warm_b = run(pipe, mix, "b float32", expect)
    out_p, _ = plain_run(pipe, mix, "p float32 plain")
    model.compute_dtype = torch.bfloat16
    pipe_err = max(float(np.abs(p - q).max()) for p, q in zip(out_b, out_p))
    if pipe_err > PIPE_ATOL:
        raise AssertionError(f"float32 path with kernels vs plain: max abs "
                             f"err {pipe_err:.3e} > {PIPE_ATOL}")
    seg = int(BF16_SEGMENT_SEC * sr)

    def bf16_gate(label, outs, ref):
        snr = best_pair_si_snr(outs, ref)
        worst = worst_segment_snr(outs, ref, seg)
        ok = snr >= BF16_SI_SNR_DB and worst >= BF16_SEGMENT_SNR_DB
        print(f"bf16_gate {label}: SI-SNR {snr:.2f} dB (floor "
              f"{BF16_SI_SNR_DB}), worst {BF16_SEGMENT_SEC:.0f} s segment "
              f"SNR {worst:.2f} dB (floor {BF16_SEGMENT_SNR_DB}): "
              f"{'pass' if ok else 'fail'}", flush=True)
        return ok, snr

    bf = pipe.beamformer
    boundaries = {"middle": (n_windows // 2) * bf.hop + bf.margin - bf.hop,
                  "last": (n_windows - 1) * bf.hop + bf.margin - bf.hop}
    for where, start in boundaries.items():
        if bf16_gate(f"control, (b) swapped from the {where} boundary",
                     swapped_from(out_b, start), out_b)[0]:
            raise AssertionError(f"the bf16 gate passes (b) with its streams "
                                 f"swapped from the {where} boundary")
    ok, bf16_snr = bf16_gate("(a) bf16 vs (b) float32", out_a, out_b)
    if not ok:
        raise AssertionError("bf16 vs float32: below the gate's floors")
    # stream re-anchoring, a host pass, once on (b)'s streams
    t = time.perf_counter()
    reanchored, n_swaps = reanchor_streams(list(out_b), sr=sr)
    reanchor_sec = time.perf_counter() - t
    if len(reanchored) != 2 or any(r.shape != o.shape or
                                   not np.isfinite(r).all()
                                   for r, o in zip(reanchored, out_b)):
        raise AssertionError("reanchor_streams: bad streams")
    print("reanchor " + json.dumps({
        "path": "conformer float32", "swaps": n_swaps,
        "host_s": reanchor_sec}), flush=True)
    print(f"main_path conformer: {SESSION_SEC:.0f} s session, {n_windows} "
          f"windows; bf16 cold {cold_a:.3f} s, warm {warm_a:.3f} s "
          f"({SESSION_SEC / warm_a:.1f} audio-sec/s); float32 warm "
          f"{warm_b:.3f} s ({SESSION_SEC / warm_b:.1f} audio-sec/s); "
          f"(b) vs plain max abs err {pipe_err:.3e} (atol {PIPE_ATOL}); "
          f"(a) vs (b) SI-SNR {bf16_snr:.2f} dB (floor {BF16_SI_SNR_DB})",
          flush=True)
    del model, pipe
    phase("conformer path", t0)

    # ----------------------------------------------------- 4. BLSTM path
    t0 = time.perf_counter()
    conf = {}  # build_model's defaults: hidden 1024, 3 layers, float32
    model = blstm.BLSTM.build_model(conf)
    model.load_state_dict(blstm.params_from_jax(
        blstm.init_params(BLSTM_SEED, conf)))
    pipe = CssPipeline(model, CONFIG, device="cuda")
    phase("blstm load", t0)
    t0 = time.perf_counter()
    n_dirs = 2 * len(model.encoders)
    expect = {"stft_mag": n_batches, "istft": 1,
              "lstm_fused": n_batches * n_dirs}
    out_f, counts_f, cold_f = run(pipe, mix, "blstm float32 (cold)", expect)
    _, _, warm_f = run(pipe, mix, "blstm float32 (warm)", expect)
    for r in results:
        if r["name"] == "lstm_fused":
            r["launches"] = counts_f["lstm_fused"]
        r["launches_by_path"]["blstm"] = counts_f[r["name"]]
    stages = stage_seconds(torch, pipe, mix, dev)
    print("stages_s " + json.dumps({"path": "blstm float32", **stages}),
          flush=True)
    masks_f = separator_masks(torch, pipe, mix, dev)
    out_q, warm_q = plain_run(pipe, mix, "blstm float32 plain")
    with plain_kernels(stft_mag_cuda, istft_cuda, lstm_cuda):
        masks_q = separator_masks(torch, pipe, mix, dev)
    mask_err = float((masks_f - masks_q).abs().max())
    stream_err = max(float(np.abs(p - q).max()) for p, q in zip(out_f, out_q))
    if mask_err > BLSTM_MASK_ATOL or stream_err > PIPE_ATOL:
        raise AssertionError(
            f"BLSTM float32 with kernels vs plain: masks max abs err "
            f"{mask_err:.3e} (atol {BLSTM_MASK_ATOL}), streams "
            f"{stream_err:.3e} (atol {PIPE_ATOL})")
    model.compute_dtype = torch.bfloat16
    run(pipe, mix, "blstm bf16 (cold)", expect)
    _, _, warm_h = run(pipe, mix, "blstm bf16 (warm)", expect)
    masks_h = separator_masks(torch, pipe, mix, dev)
    diff = (masks_h - masks_f).abs()
    bf16_max, bf16_mean = float(diff.max()), float(diff.mean())
    if bf16_max > BLSTM_BF16_MAX or bf16_mean > BLSTM_BF16_MEAN:
        raise AssertionError(
            f"BLSTM bf16 vs float32 masks: max {bf16_max:.3e} (bound "
            f"{BLSTM_BF16_MAX}), mean {bf16_mean:.3e} (bound "
            f"{BLSTM_BF16_MEAN})")
    print(f"main_path blstm: hidden 1024 x {len(model.encoders)} layers, "
          f"{SESSION_SEC:.0f} s session; float32 cold {cold_f:.3f} s, warm "
          f"{warm_f:.3f} s ({SESSION_SEC / warm_f:.1f} audio-sec/s); plain "
          f"float32 warm {warm_q:.3f} s ({SESSION_SEC / warm_q:.1f} "
          f"audio-sec/s); bf16 warm {warm_h:.3f} s ({SESSION_SEC / warm_h:.1f}"
          f" audio-sec/s); launches {counts_f}; float32 vs plain: masks "
          f"max abs err {mask_err:.3e} (atol {BLSTM_MASK_ATOL}), streams "
          f"{stream_err:.3e} (atol {PIPE_ATOL}); bf16 vs float32 masks: max "
          f"{bf16_max:.3e} (bound {BLSTM_BF16_MAX}), mean {bf16_mean:.3e} "
          f"(bound {BLSTM_BF16_MEAN})", flush=True)
    del model, pipe
    phase("blstm path", t0)

    # ------------------------------------------------ 5. Conformer 7ch path
    t0 = time.perf_counter()
    model = load_model(CHECKPOINT_7CH)
    if model.compute_dtype != torch.bfloat16:
        raise AssertionError("the 7ch checkpoint's conf should select bf16")
    rec = session_7ch(srcs)
    pipe = CssPipeline(model, CONFIG_7CH, device="cuda")
    phase("7ch load", t0)
    t0 = time.perf_counter()
    expect = {"stft_mag": n_batches, "istft": 1, "lstm_fused": 0}

    def run_7ch(label, plain=False):
        if plain:
            outs, sec = plain_run(pipe, rec, label)
            counts = None
        else:
            outs, counts, sec = run(pipe, rec, label, expect)
        kills = int(pipe.separator.merge_kills)
        log(f"run {label}: DOA merge killed {kills} of {n_windows} windows")
        return outs, counts, sec, kills

    out7_a, counts_7, cold7_a, kills_a = run_7ch("7ch a bf16 (cold)")
    _, _, warm7_a, _ = run_7ch("7ch a bf16 (warm)")
    stages = stage_seconds(torch, pipe, rec, dev)
    print("stages_s " + json.dumps({"path": "conformer 7ch bf16", **stages}),
          flush=True)
    model.compute_dtype = torch.float32
    out7_b, _, warm7_b, kills_b = run_7ch("7ch b float32")
    stages_b = stage_seconds(torch, pipe, rec, dev)
    print("stages_s " + json.dumps({"path": "conformer 7ch float32",
                                    **stages_b}), flush=True)
    out7_p, _, _, kills_p = run_7ch("7ch p float32 plain", plain=True)
    lib = library_times(torch, pipe, rec, dev)
    print("library_7ch " + json.dumps(lib), flush=True)
    model.compute_dtype = torch.bfloat16
    err7 = max(float(np.abs(p - q).max()) for p, q in zip(out7_b, out7_p))
    if err7 > PIPE_ATOL or kills_b != kills_p:
        raise AssertionError(
            f"7ch float32 path with kernels vs plain: max abs err {err7:.3e}"
            f" (atol {PIPE_ATOL}), DOA-merge kills {kills_b} vs {kills_p}")
    for where, start in boundaries.items():
        if bf16_gate(f"7ch control, (b) swapped from the {where} boundary",
                     swapped_from(out7_b, start), out7_b)[0]:
            raise AssertionError(f"the 7ch bf16 gate passes (b) with its "
                                 f"streams swapped from the {where} boundary")
    ok, bf16_snr7 = bf16_gate("7ch (a) bf16 vs (b) float32", out7_a, out7_b)
    if not ok:
        raise AssertionError("7ch bf16 vs float32: below the gate's floors")
    # SI-SNRi of (b) against the voices' images at channel 0 (the voices
    # themselves), under the better stream order
    base = [si_snr_db(rec[0], s_) for s_ in srcs]
    direct = np.mean([si_snr_db(out7_b[i], srcs[i]) - base[i]
                      for i in range(2)])
    swapped = np.mean([si_snr_db(out7_b[i], srcs[1 - i]) - base[1 - i]
                       for i in range(2)])
    si_snri = float(max(direct, swapped))
    if si_snri < SI_SNRI_7CH_DB or kills_b > MAX_KILL_SHARE * n_windows:
        raise AssertionError(
            f"the 7ch checkpoint does not separate the session: SI-SNRi of "
            f"(b) {si_snri:.2f} dB (floor {SI_SNRI_7CH_DB}), DOA merge kills "
            f"{kills_b} of {n_windows} windows (at most {MAX_KILL_SHARE:.0%})")
    for r in results:
        r["launches_by_path"]["conformer_7ch"] = counts_7[r["name"]]
    print(f"main_path conformer_7ch: {SESSION_SEC:.0f} s 7-channel session, "
          f"{n_windows} windows, azimuths {AZIMUTHS_7CH}; bf16 cold "
          f"{cold7_a:.3f} s, warm {warm7_a:.3f} s "
          f"({SESSION_SEC / warm7_a:.1f} audio-sec/s); float32 warm "
          f"{warm7_b:.3f} s ({SESSION_SEC / warm7_b:.1f} audio-sec/s); "
          f"launches {counts_7}; DOA merge kills bf16 {kills_a}, float32 "
          f"{kills_b}, plain {kills_p}; (b) vs plain max abs err {err7:.3e} "
          f"(atol {PIPE_ATOL}); (a) vs (b) SI-SNR {bf16_snr7:.2f} dB (floor "
          f"{BF16_SI_SNR_DB}); SI-SNRi of (b) {si_snri:.2f} dB (floor "
          f"{SI_SNRI_7CH_DB})", flush=True)
    del model, pipe
    phase("conformer 7ch path", t0)

    # ------------------------------------------- 6. Conformer train path
    t0 = time.perf_counter()
    steps = train_path(torch, dev, results, counters, stft_mag_cuda,
                       istft_cuda, lstm_cuda, mix)
    print("train_steps " + json.dumps(steps), flush=True)
    print(f"main_path conformer_train: batch {steps['batch']} x "
          f"{steps['window_s']:.1f} s; Conformer bf16 "
          f"{steps['conformer']['bf16_ms']:.1f} ms/step "
          f"({steps['conformer']['bf16_audio_sec_per_s']:.1f} audio-sec/s), "
          f"float32 {steps['conformer']['float32_ms']:.1f} ms/step; BLSTM "
          f"bf16 {steps['blstm']['bf16_ms']:.1f} ms/step, float32 "
          f"{steps['blstm']['float32_ms']:.1f} ms/step; {smi_line}",
          flush=True)
    phase("conformer train path", t0)

    # ------------------------------------------ 7. Conformer 7ch train path
    t0 = time.perf_counter()
    rec7 = train_7ch_path(torch, dev, results, counters,
                          (stft_mag_cuda, istft_cuda, lstm_cuda), smi_line)
    print("train_7ch " + json.dumps(rec7), flush=True)
    print(f"main_path conformer_7ch_train: batch {rec7['batch']} x "
          f"{rec7['window_s']:.1f} s on 7 channels; step ms {rec7['step_ms']};"
          f" probe s {rec7['probe_s']}; recipe run {rec7['recipe_s']:.1f} s; "
          f"{smi_line}", flush=True)
    phase("conformer 7ch train path", t0)

    # ------------------------------------------------------- 8. streaming
    t0 = time.perf_counter()
    rec8 = stream_path(torch, dev, results, counters,
                       (stft_mag_cuda, istft_cuda, lstm_cuda), mix, srcs,
                       bf16_gate, boundaries, smi_line)
    w, h = rec8["window"]["float32"], rec8["hop_blstm"]
    print(f"main_path stream: window mode {SESSION_SEC:.0f} s in "
          f"{PUSH_SEC} s pushes, float32 push median "
          f"{1e3 * w['push_s_median']:.2f} ms, p90 "
          f"{1e3 * w['push_s_p90']:.2f} ms, lag median "
          f"{w['lag_s_median']:.2f} s, max {w['lag_s_max']:.2f} s; hop mode "
          f"causal BLSTM chunk median {1e3 * h['chunk_s_median']:.2f} ms, "
          f"p90 {1e3 * h['chunk_s_p90']:.2f} ms; causal Conformer chunk "
          f"median {1e3 * rec8['hop_conformer']['chunk_s_median']:.2f} ms; "
          f"{smi_line}", flush=True)
    phase("streaming", t0)

    # --------------------------------------------------------- 9. parallel
    t0 = time.perf_counter()
    rec9 = parallel_path(torch, dev, results, counters, mix, smi_line)
    rec9["g"] = sharded_path(torch, dev, results, counters, mix)
    print("parallel " + json.dumps(rec9), flush=True)
    print(f"main_path parallel (ranks share one card: correctness and "
          f"overhead, not scaling): dp step world 1 (nccl) "
          f"{rec9['a']['step_ms']:.1f} ms vs single "
          f"{rec9['a']['single_step_ms']:.1f} ms; world 2 (gloo) "
          f"{max(rec9['b']['step_ms']):.1f} ms; tp 2 step "
          f"{max(rec9['c']['step_ms']):.1f} ms; sharded over 2 shards "
          f"conformer {rec9['g']['conformer']['sharded_s']:.3f} s vs "
          f"{rec9['g']['conformer']['unsharded_s']:.3f} s unsharded, blstm "
          f"{rec9['g']['blstm']['sharded_s']:.3f} s vs "
          f"{rec9['g']['blstm']['unsharded_s']:.3f} s; {smi_line}",
          flush=True)
    phase("parallel", t0)

    # ------------------------------------ 10. export, serve, import, tools
    t0 = time.perf_counter()
    rec10 = export_serve_path(torch, dev, results, run, mix)
    print("export_serve " + json.dumps(rec10), flush=True)
    sv, tl = rec10["serve"], rec10["tools"]
    print(f"main_path export_serve: exported flagship "
          f"{sv['conformer']['export_s']:.1f} s ({sv['conformer']['bytes']} "
          f"bytes), blstm {sv['blstm']['export_s']:.1f} s "
          f"({sv['blstm']['bytes']} bytes, K2 op nodes "
          f"{len(sv['blstm']['port_ops'])}); served vs live session s: "
          f"flagship {sv['conformer']['served_s_median']:.4f} vs "
          f"{sv['conformer']['live_s_median']:.4f} (masks max abs "
          f"{sv['conformer']['mask_max_abs']:.3e}), blstm "
          f"{sv['blstm']['served_s_median']:.4f} vs "
          f"{sv['blstm']['live_s_median']:.4f} (masks max abs "
          f"{sv['blstm']['mask_max_abs']:.3e}), served blstm launches "
          f"{sv['blstm']['launches']}; import masks max abs "
          f"{rec10['import']['mask_max_abs']:.3e}; libricss recipe "
          f"{tl['recipe_s']:.1f} s, stages {tl['stages_s']}, WER "
          f"{tl['wer']['wer']}, SI-SNRi {tl['mean_si_snri_db']:.2f} dB; "
          f"{smi_line}", flush=True)
    phase("export, serve, import, tools", t0)

    print(json.dumps({"kernels": results}), flush=True)
    print(smi_line, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
