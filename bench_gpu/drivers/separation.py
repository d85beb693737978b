"""Offline continuous separation in a closed loop.

Set-up: the model with the seed's weights, the program's ``CssPipeline``
under the configuration's pipeline settings, and a pool of
``traffic['pool']`` sessions made from the seed (``harness/sessions.py``:
(T,), or (channels, T) where the traffic's ``session`` names more than
one channel) and copied to the host, where the pipeline takes
recordings; then
``warm_sessions`` calls of ``CssPipeline.process``, which build the
kernels, run the separator's forward eagerly once and capture it.

Window: one recording at a time through ``CssPipeline.process``, cycling
the pool, until ``seconds`` have passed; the window closes when the
session running then returns its streams. ``sep_rate`` is the audio
seconds of every session whose streams reached the host as numpy, over
the window's wall time.

Traced run: the same window under the profiler, with the benchmark's
spans around the whole call and around the pipeline instance's
``separator.separate``, stitcher call and ``beamformer.
continuous_process``, each ended by a synchronise.

Check: ``check_sessions`` sessions drawn from the seed among those the
window finished (a reservoir), their streams kept as the window returned
them. Once the window is closed and the program freed, the reference
separates each drawn session's recording: the configuration's pipeline
reference (``pipeline_reference``, ``reference/separation.py`` where it
names none) around its model reference (``reference``), float32, TF32
off, the same weights re-made from the seed; ``errors`` takes the
streams' relative errors, and the configuration's ``limits`` name the
ones compared. So a configuration with another pipeline (more channels,
another beamformer) brings a configuration, a traffic file and a
reference, and runs through this driver.

``TINY``: the overrides that cut this driver's cells to a CPU test's size.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np
import torch

from bench_gpu.harness import manifest, readers, sessions
from bench_gpu.harness.setup import (Launches, Outcome, Reservoir, free,
                                     memory_peak, pipeline_reference,
                                     program_model, reference, weights_for)
from bench_gpu.reference.precision import strict_float32

ELEM = {"float32": 4, "bfloat16": 2}

TINY = {
    "config": {"widths": {"num_blocks": 1, "num_layers": 1,
                          "hidden_dim": 64},
               "program_conf": {"conformer_num_blocks": 1,
                                "blstm_num_layers": 1,
                                "blstm_hdim": 64}},
    "traffic": {"session": {"seconds": 5}, "pool": 2,
                "warm_sessions": 1, "check_sessions": 2}}


def make_pool(traffic: Dict, seed: int, device) -> List[np.ndarray]:
    return [sessions.session(traffic["session"], seed, i, device)
            .cpu().numpy() for i in range(int(traffic["pool"]))]


class _Span:
    """The pipeline's stitcher, its call inside a span (a call operator is
    looked up on the type, so the instance attribute is replaced by this
    proxy)."""

    def __init__(self, inner, tracer):
        self._call = tracer.wrap(inner, "stitcher")

    def __call__(self, *args, **kwargs):
        return self._call(*args, **kwargs)


def errors(outs: Tuple[np.ndarray, ...], refs: Tuple[torch.Tensor, ...],
           frame: int) -> Dict[str, float]:
    """Relative errors of the streams ``outs`` against ``refs``, the
    worst stream's, over the session's ``frame``-sample frames (frames
    whose reference energy is below 1e-6 of the mean frame's left out).
    Each stream's gain is first matched to the reference's: the pipeline
    scales a stream to a peak of 0.9, and which sample peaks can move with
    rounding, which scales the whole stream; the gain is the median over
    frames of <y, r> / <r, r>, which the few frames a rounding changes do
    not move (``gain_gap``: |gain - 1|). Then ``stream_err`` is
    ||y / gain - r|| / ||r|| over the session, and ``frame_p50``,
    ``frame_p90``, ``frame_p99`` the quantiles over frames of the same
    ratio a frame. A quantile is blind to the few frames where a rounding
    flips one bin's winner-take-all decision, which the whole session's
    error is not."""
    out = {"stream_err": 0.0, "frame_p50": 0.0, "frame_p90": 0.0,
           "frame_p99": 0.0, "gain_gap": 0.0}
    qs = torch.tensor([0.5, 0.9, 0.99], dtype=torch.float64)
    for y, r in zip(outs, refs):
        r = r.double()
        y = torch.as_tensor(y, device=r.device).double()
        n = (r.shape[0] // frame) * frame
        yf, rf = y[:n].reshape(-1, frame), r[:n].reshape(-1, frame)
        r2 = torch.square(rf).sum(1)
        keep = r2 > 1e-6 * r2.mean()
        gain = float(torch.median((yf * rf).sum(1)[keep] / r2[keep]))
        if not gain > 0:
            gain = 1.0
        e2 = torch.square(yf / gain - rf).sum(1)
        out["gain_gap"] = max(out["gain_gap"], abs(gain - 1.0))
        out["stream_err"] = max(out["stream_err"],
                                float(torch.sqrt(e2.sum() / r2.sum())))
        q = torch.quantile(torch.sqrt(e2[keep] / r2[keep]),
                           qs.to(r.device)).tolist()
        for k, v in zip(("frame_p50", "frame_p90", "frame_p99"), q):
            out[k] = max(out[k], v)
    return out


def reference_streams(config: Dict, p: Dict, wav: np.ndarray, device,
                      mode: str = "f32", root: Path = manifest.ROOT
                      ) -> Tuple[torch.Tensor, ...]:
    """The reference's streams of one recording with weights ``p``, in
    precision ``mode``."""
    strict_float32()
    ref = reference(config, root)
    widths = config["widths"]
    return pipeline_reference(config, root).separate(
        torch.as_tensor(wav, device=device),
        lambda feats: ref.masks(p, feats, widths, mode=mode),
        config["pipeline"], widths["num_spk"])


def judge(config: Dict, traffic: Dict, seed: int, sample, pool, device,
          mode: str = "f32", root: Path = manifest.ROOT
          ) -> List[Dict[str, float]]:
    """The numbers compared, one dict a drawn session of ``sample``
    [(pool index, streams)]."""
    frame = int(config["pipeline"]["separation"]["frame_length"])
    p = weights_for(config, seed, device, root)
    return [errors(outs, reference_streams(config, p, pool[i], device, mode,
                                           root), frame)
            for i, outs in sample]


def run(cell, seed: int, seconds: float, device, tracer, t0: float,
        hooks: Dict) -> Outcome:
    from css_tpu_torch.executor.pipeline import CssPipeline

    cfg, traffic = cell.config, cell.traffic
    model = program_model(cfg, seed, device, cell.root)
    pipe = CssPipeline(model, cfg["pipeline"], device=device)
    pool = make_pool(traffic, seed, device)
    if "pipeline" in hooks:  # tests: break the timed path underneath
        hooks["pipeline"](pipe)
    for i in range(int(traffic["warm_sessions"])):
        pipe.process(pool[i % len(pool)])
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t0

    if tracer.enabled:
        pipe.separator.separate = tracer.wrap(pipe.separator.separate,
                                              "separator")
        pipe.stitcher = _Span(pipe.stitcher, tracer)
        pipe.beamformer.continuous_process = tracer.wrap(
            pipe.beamformer.continuous_process, "beamformer")
    if tracer.enabled:  # a traced window may be shorter (the trace's size)
        seconds = min(seconds, float(traffic.get("trace_seconds", seconds)))
    sample = Reservoir(int(traffic["check_sessions"]), seed)
    launches = Launches(cell.root)
    done = 0
    with tracer.window():
        start = time.perf_counter()
        while True:
            i = done % len(pool)
            with tracer.span("session"):
                outs = pipe.process(pool[i])
            done += 1
            sample.offer((i, outs))
            if time.perf_counter() - start >= seconds:
                break
        wall = time.perf_counter() - start
    counts = launches.since()
    peak = memory_peak(device)

    sec = float(traffic["session"]["seconds"])
    rec = None
    if tracer.enabled:
        rec = _record(cell, pipe, pool, tracer, done, counts,
                      launches.missing)
    del pipe, model
    free(device)

    limits = cfg["limits"]["separation"]
    judged = judge(cfg, traffic, seed, sample.items, pool, device,
                   root=cell.root)
    checks = {k: {"value": max((j[k] for j in judged), default=None),
                  "limit": v} for k, v in limits.items()}
    failed = sum(any(j[k] > v for k, v in limits.items()) for j in judged)
    correct = bool(judged) and failed == 0
    return Outcome(correct=correct, attempted=done, failed=failed,
                   metrics={"sep_rate": done * sec / wall,
                            "setup_s": setup_s},
                   checks=checks, memory_peak=peak, record=rec)


def _record(cell, pipe, pool, tracer, done, counts: Dict[str, int],
            missing: Dict[str, str]) -> readers.Record:
    """What the readers read: the window's counts and, by kernel, its
    launches with the shape each cost file gives them (``shape``) at this
    cell's geometry."""
    sep = pipe.separator
    n = pool[0].shape[-1]
    total = n if n >= sep.win else sep.win
    windows = max(1, -(-(total - sep.win) // sep.hop) + 1)
    cfg = cell.config
    geo = {"batch": sep.batch_size, "win": sep.win, "hop": sep.hop,
           "frames": (sep.win - sep.features.frame_len)
           // sep.features.frame_hop + 1,
           "windows": windows, "batches": -(-windows // sep.batch_size),
           "samples": n, "channels": pool[0].shape[0] if pool[0].ndim == 2
           else 1, "streams": pipe.num_spk, "elem": ELEM[cfg["dtype"]]}
    cost = manifest.cost(cell.config_name, cell.root)
    rec = readers.Record(tracer=tracer, config=cfg, root=cell.root,
                         missing=dict(missing))
    rec.counts = {"sessions": done,
                  "model_flops": done * geo["batches"] * cost.forward_flops(
                      cfg["widths"], sep.batch_size, geo["frames"])}
    for key, count in counts.items():
        if not count or key in rec.missing:
            continue
        shape = manifest.cost(key, cell.root).shape(cfg, geo)
        if shape is None:
            rec.why.append(f"{key}: {count} launches, and the cell gives "
                           "them no shape")
            continue
        rec.work[key] = [(count, shape)]
    return rec
