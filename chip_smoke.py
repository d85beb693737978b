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
Then one JSON line of per-kernel numbers, the card's name and power limit,
and last the result line ``{"ok": true, "device": {...}}``. Progress goes
to stderr. Any failed check raises, and the exit code is then non-zero;
without a CUDA device the script exits 1 and prints no result.
"""

from __future__ import annotations

import contextlib
import functools
import json
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
    sr = CONFIG["sampling_rate"]
    win = int(sep["eval_win"] * sr) + EXTRA_SAMPLES
    win_hop = int(sep["eval_hop"] * sr)
    frame, hop = sep["frame_length"], sep["frame_shift"]
    return {"batch": sep["batch_size"], "win": win, "frame": frame,
            "hop": hop, "n_frames": (win - frame) // hop + 1,
            "n_windows": -(-(int(SESSION_SEC * sr) - win) // win_hop) + 1}


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


def step_ms(torch, trainer, batch, steps: int, warmup: int = 1):
    """Median host ms of warm train steps, each ending in a synchronize,
    and the losses of all steps."""
    times, losses = [], []
    for i in range(warmup + steps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        m = trainer.train_step(batch)
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
    got = counted(stft_mag_cuda.stft_mag, 1, "stft_mag train",
                  lambda: stft_mag_cuda.stft_mag(x, frame, hop))
    want = stft_mag_cuda.stft_mag_plain(x, frame, hop)
    torch.cuda.synchronize()
    err = check_close("stft_mag train", got, want, KERNEL_ATOL, KERNEL_RTOL)
    hann = torch.hann_window(frame, device=dev)

    def lib_fn():
        return torch.stft(x, frame, hop, window=hann, center=False,
                          return_complex=True).abs()

    bins, t = got.shape[2], got.shape[1]
    bnd, by = bound_ms(x.shape[0] * t * (frame + rfft_flops(frame)
                                         + 4 * bins),
                       4.0 * (x.numel() + got.numel()))
    k3 = {"shape": list(x.shape), "max_abs_err": err,
          "ms": time_ms(torch, lambda: stft_mag_cuda.stft_mag(x, frame, hop)),
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
    log(f"K3 stft_mag train {tuple(x.shape)}: {json.dumps(k3)}")
    for r in results:
        if r["name"] == "stft_mag":
            r["train"] = k3
    del x, got, want

    # (a) K3 vs plain in one float32 step from one state
    trainer = make_trainer(torch, "Conformer", {}, 1e-4, dev)
    state0 = trainer.state()

    def step_grads(plain: bool, which=batch):
        trainer.load_state(state0)
        trainer.generator.manual_seed(TRAIN_SEED)
        if plain:
            with plain_kernels(stft_mag_cuda, istft_cuda, lstm_cuda):
                loss, _, norm = trainer.compute_grads(which)
        else:
            loss, _, norm = counted(stft_mag_cuda.stft_mag, 1, "train (a)",
                                    lambda: trainer.compute_grads(which))
        return float(loss.detach()), float(norm), grads_of(torch, trainer)

    loss_k, norm_k, g_k = step_grads(False)
    loss_p, norm_p, g_p = step_grads(True)
    _, _, g_ctrl = step_grads(False, train_batch(TRAIN_SEED + 1))
    l2 = rel_l2(torch, g_k, g_p)
    l2_ctrl = rel_l2(torch, g_ctrl, g_p)
    elem = max(float((a - c).abs().max() / max(float(c.abs().max()), 1e-30))
               for a, c in zip(g_k, g_p))
    check_a = {"loss_kernel": loss_k, "loss_plain": loss_p,
               "loss_rel": abs(loss_k - loss_p) / abs(loss_p),
               "grad_norm_rel": abs(norm_k - norm_p) / norm_p,
               "grad_rel_l2": l2, "control_grad_rel_l2": l2_ctrl,
               "max_elem_err_of_tensor_max": elem}
    print("train_check_a " + json.dumps(check_a), flush=True)
    if not (check_a["loss_rel"] <= TRAIN_LOSS_RTOL
            and check_a["grad_norm_rel"] <= TRAIN_NORM_RTOL
            and l2 <= TRAIN_GRAD_L2 and np.isfinite(loss_k)):
        raise AssertionError(f"train step with K3 vs plain: {check_a}")
    if not l2_ctrl > TRAIN_GRAD_L2:
        raise AssertionError(f"the gradient gate passes another batch's "
                             f"gradient ({l2_ctrl:.3e})")
    del g_k, g_p, g_ctrl
    trainer.load_state(state0)
    f32_ms, _ = step_ms(torch, trainer, batch, 5, warmup=2)
    del trainer, state0
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        log("chip_smoke: torch.cuda.is_available() is False; nothing run")
        return 1

    from css_tpu_torch.cli.separate import load_model
    from css_tpu_torch.executor.pipeline import CssPipeline
    from css_tpu_torch.models import blstm
    from css_tpu_torch.executor.reanchor import reanchor_streams
    from css_tpu_torch.ops import _build, istft_cuda, lstm_cuda, stft_mag_cuda
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
    main2 = lstm_cases[0]  # hidden 512, float32, forward: the BLSTM's
    results.append({
        "name": "lstm_fused", "route": "cuda",
        "source": "css_tpu_torch/csrc/lstm.cu",
        "replaces": "css_tpu/ops/lstm_pallas.py:103",
        "launches": None, "max_abs_err": max(
            c["max_abs_err"] for c in lstm_cases if c["dtype"] == "float32"),
        "ms": main2["ms"], "plain_ms": main2["plain_ms"],
        "bound_ms": main2["bound_ms"], "bound_by": main2["bound_by"],
        "library_ms": lib2, "device_ms": dev2})
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

    print(json.dumps({"kernels": results}), flush=True)
    print(smi_line, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
