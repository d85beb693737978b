#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (css_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each timed on its own line:
  1. device: the card, its name and power limit (nvidia-smi), and the
     build of every CUDA kernel from ``css_tpu_torch/csrc`` (nvcc, cold).
  2. kernels: each kernel against its plain PyTorch version on the card,
     in float32 with TF32 off, at the main path's shapes; kernel, plain
     and library times (CUDA events, median of 30 after 3 warm-ups).
  3. main path: the committed flagship checkpoint through
     ``CssPipeline.process`` on a 60 s synthetic 2-talker session, with
     launch counts reset before and read after each run:
       (a) the flagship's own bf16 compute, with the kernels;
       (b) float32 compute (TF32 off), with the kernels;
       (p) float32 compute on the plain versions (no kernel launch);
     (b) must match (p), and (a) must match (b) above an SI-SNR floor
     and a worst-segment SNR floor, which two stream-swapped copies of
     (b) must fail.
Then one JSON line of per-kernel numbers, the card's name and power limit,
and last the result line ``{"ok": true, "device": {...}}``. Progress goes
to stderr. Any failed check raises, and the exit code is then non-zero;
without a CUDA device the script exits 1 and prints no result.
"""

from __future__ import annotations

import contextlib
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

# H100 SXM data sheet: FP32 on the CUDA cores (both kernels run FP32 FMAs)
# and HBM3 bandwidth. Rates at the full 700 W power limit.
PEAK_FP32_FLOPS = 67e12
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


def rfft_flops(n: int) -> float:
    """Operations of one length-n real FFT (or its inverse) by a radix-2
    algorithm: half of the complex FFT's 5 n log2 n."""
    return 2.5 * n * np.log2(n)


def bound_ms(flops: float, nbytes: float):
    """Least time for flops FP32 operations and nbytes of device memory
    traffic, and which of the two bounds it."""
    t_ops = flops / PEAK_FP32_FLOPS
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
def plain_kernels(stft_mag_cuda, istft_cuda):
    """Route the main path through the kernels' plain versions."""
    saved = stft_mag_cuda.stft_mag, istft_cuda.istft
    stft_mag_cuda.stft_mag = stft_mag_cuda.stft_mag_plain
    istft_cuda.istft = istft_cuda.istft_plain
    try:
        yield
    finally:
        stft_mag_cuda.stft_mag, istft_cuda.istft = saved


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        log("chip_smoke: torch.cuda.is_available() is False; nothing run")
        return 1

    from css_tpu_torch.cli.separate import load_model
    from css_tpu_torch.executor.pipeline import CssPipeline
    from css_tpu_torch.executor.windowing import (EXTRA_SAMPLES,
                                                  pad_for_windows)
    from css_tpu_torch.ops import _build, istft_cuda, stft_mag_cuda
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
    rng = np.random.default_rng(SEED)
    sep_conf = CONFIG["separation"]
    frame, hop = sep_conf["frame_length"], sep_conf["frame_shift"]
    sr = CONFIG["sampling_rate"]
    win = int(sep_conf["eval_win"] * sr) + EXTRA_SAMPLES
    win_hop = int(sep_conf["eval_hop"] * sr)
    batch = sep_conf["batch_size"]
    # windows that cover the session (73 for 60 s at the 0.8 s hop)
    n_windows = -(-(int(SESSION_SEC * sr) - win) // win_hop) + 1
    bins = frame // 2 + 1
    results = []

    # K3 on one separator batch of windows
    x = torch.as_tensor(rng.standard_normal((batch, win)).astype(np.float32)
                        * 0.1, device=dev)
    got = stft_mag_cuda.stft_mag(x, frame, hop)
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
    # the function's least work: per frame a window multiply, a real FFT
    # and |.| of every bin; the signal read once, the magnitudes written
    # once. The kernel's own DFT-as-matrix-product count is logged beside.
    b3, by3 = bound_ms(
        batch * n_frames * (frame + rfft_flops(frame) + 4 * bins),
        4.0 * (x.numel() + got.numel()))
    dft3, _ = bound_ms(2.0 * batch * n_frames * frame * 2 * bins, 0.0)
    log(f"K3 stft_mag {tuple(x.shape)}: max_abs_err {err3:.3e} (torch.stft "
        f"{lib_err:.3e}); kernel_ms {ms3:.4f} plain_ms {plain3:.4f} "
        f"library_ms {lib3:.4f} bound_ms {b3:.4f} ({by3}); "
        f"dft_matmul_flops_ms {dft3:.4f}")
    results.append({
        "name": "stft_mag", "route": "cuda",
        "source": "css_tpu_torch/csrc/stft_mag.cu",
        "replaces": "css_tpu/ops/_stft_pallas_r01.py:74",
        "launches": None, "max_abs_err": err3, "ms": ms3, "plain_ms": plain3,
        "bound_ms": b3, "bound_by": by3, "library_ms": lib3})

    # K1 on every masked stream of a 60 s recording: 2 x 73 rows
    rows = 2 * n_windows
    sig = torch.as_tensor(rng.standard_normal((rows, win)).astype(np.float32)
                          * 0.1, device=dev)
    mask = torch.as_tensor(rng.uniform(0.0, 1.0, (rows, n_frames, bins))
                           .astype(np.float32), device=dev)
    spec = (stft_ops.stft(sig, frame, hop) * mask).contiguous()
    got = istft_cuda.istft(spec, frame, hop)
    want = istft_cuda.istft_plain(spec, frame, hop)
    torch.cuda.synchronize()
    err1 = check_close("istft", got, want, KERNEL_ATOL, KERNEL_RTOL)
    ms1 = time_ms(torch, lambda: istft_cuda.istft(spec, frame, hop))
    plain1 = time_ms(torch, lambda: istft_cuda.istft_plain(spec, frame, hop))
    # least work: per frame an inverse real FFT and a window multiply, per
    # sample an overlap add and the envelope multiply; the spectrum read
    # once, the signal written once
    b1, by1 = bound_ms(
        rows * n_frames * (frame + rfft_flops(frame)) + 2.0 * got.numel(),
        8.0 * spec.numel() + 4.0 * got.numel())
    dft1, _ = bound_ms(2.0 * rows * n_frames * 2 * bins * frame, 0.0)
    # torch.istft(center=False) refuses the periodic Hann window (its
    # envelope is 0 at the first sample: the NOLA check fails), so K1 has
    # no one-call library counterpart
    log(f"K1 istft {tuple(spec.shape)}: max_abs_err {err1:.3e}; kernel_ms "
        f"{ms1:.4f} plain_ms {plain1:.4f} bound_ms {b1:.4f} ({by1}); "
        f"dft_matmul_flops_ms {dft1:.4f}")
    results.append({
        "name": "istft", "route": "cuda",
        "source": "css_tpu_torch/csrc/istft.cu",
        "replaces": "css_tpu/ops/istft_pallas.py:87",
        "launches": None, "max_abs_err": err1, "ms": ms1, "plain_ms": plain1,
        "bound_ms": b1, "bound_by": by1, "library_ms": None})
    del x, sig, mask, spec, got, want
    phase("kernels", t0)

    # ------------------------------------------------------- 3. main path
    t0 = time.perf_counter()
    model = load_model(CHECKPOINT)
    if model.compute_dtype != torch.bfloat16:
        raise AssertionError("the flagship's conf should select bf16")
    mix, _ = synthetic_session(SESSION_SEC, CONFIG["sampling_rate"], SEED)
    pipe = CssPipeline(model, CONFIG, device="cuda")
    phase("load", t0)
    counters = (stft_mag_cuda.stft_mag, istft_cuda.istft)
    expect = {"stft_mag": -(-n_windows // batch), "istft": 1}

    def run(label, check_counts=True):
        for c in counters:
            c.launches = 0
        t = time.perf_counter()
        outs = pipe.process(mix)  # ends with a device-to-host copy
        sec = time.perf_counter() - t
        counts = {c.__name__: c.launches for c in counters}
        if check_counts and counts != expect:
            raise AssertionError(f"run {label}: launches {counts}, "
                                 f"expected {expect}")
        if len(outs) != 2:
            raise AssertionError(f"run {label}: {len(outs)} streams")
        for o in outs:
            if o.shape != mix.shape or not np.isfinite(o).all():
                raise AssertionError(f"run {label}: bad stream {o.shape}")
            if abs(float(np.abs(o).max()) - 0.9) > 1e-4:
                raise AssertionError(f"run {label}: peak {np.abs(o).max()}")
        log(f"run {label}: {sec:.3f} s, {SESSION_SEC / sec:.1f} audio-sec/s, "
            f"launches {counts}")
        return outs, counts, sec

    out_a, counts_a, cold_a = run("a bf16 (cold)")
    _, _, warm_a = run("a bf16 (warm)")
    for r in results:
        r["launches"] = counts_a[r["name"]]

    # per-stage seconds of the warm bf16 path
    wav = torch.as_tensor(mix, device=dev)
    wav = pad_for_windows(wav, pipe.separator.win, pipe.separator.hop)
    stages = {}
    torch.cuda.synchronize()
    t = time.perf_counter()
    masks, mags = pipe.separator.separate(wav)
    torch.cuda.synchronize()
    stages["separator"] = time.perf_counter() - t
    t = time.perf_counter()
    stitched = pipe.stitcher(masks, mags)
    torch.cuda.synchronize()
    stages["stitcher"] = time.perf_counter() - t
    t = time.perf_counter()
    outs = pipe.beamformer.continuous_process(wav, stitched)
    torch.cuda.synchronize()
    stages["beamformer"] = time.perf_counter() - t
    t = time.perf_counter()
    [o.cpu() for o in outs]
    stages["to_host"] = time.perf_counter() - t
    print("stages_s " + json.dumps(stages), flush=True)

    model.compute_dtype = torch.float32
    out_b, _, warm_b = run("b float32")
    with plain_kernels(stft_mag_cuda, istft_cuda):
        out_p, counts_p, _ = run("p float32 plain", check_counts=False)
    if any(counts_p.values()):
        raise AssertionError(f"plain run launched kernels: {counts_p}")
    model.compute_dtype = torch.bfloat16
    pipe_err = max(float(np.abs(p - q).max()) for p, q in zip(out_b, out_p))
    if pipe_err > PIPE_ATOL:
        raise AssertionError(f"float32 path with kernels vs plain: max abs "
                             f"err {pipe_err:.3e} > {PIPE_ATOL}")
    seg = int(BF16_SEGMENT_SEC * sr)

    def bf16_gate(label, outs):
        snr = best_pair_si_snr(outs, out_b)
        worst = worst_segment_snr(outs, out_b, seg)
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
                     swapped_from(out_b, start))[0]:
            raise AssertionError(f"the bf16 gate passes (b) with its streams "
                                 f"swapped from the {where} boundary")
    ok, bf16_snr = bf16_gate("(a) bf16 vs (b) float32", out_a)
    if not ok:
        raise AssertionError("bf16 vs float32: below the gate's floors")
    print(f"main_path: {SESSION_SEC:.0f} s session, {n_windows} windows; "
          f"bf16 cold {cold_a:.3f} s, warm {warm_a:.3f} s "
          f"({SESSION_SEC / warm_a:.1f} audio-sec/s); float32 warm "
          f"{warm_b:.3f} s ({SESSION_SEC / warm_b:.1f} audio-sec/s); "
          f"(b) vs plain max abs err {pipe_err:.3e} (atol {PIPE_ATOL}); "
          f"(a) vs (b) SI-SNR {bf16_snr:.2f} dB (floor {BF16_SI_SNR_DB})",
          flush=True)
    phase("main path", t0)

    print(json.dumps({"kernels": results}), flush=True)
    print(smi_line, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
