"""Offline continuous separation by a time-domain model in a closed loop.

The separation driver's run (``drivers/separation.py``), for a model that
maps waveform windows to waveforms (Conv-TasNet): the same set-up from
the seed, the same pool of sessions, warm calls, window and sampled
check, with the pieces that differ:

  * the program's path is ``CssPipeline.process`` on a time-domain model:
    the separator's per-window streams, ``Stitcher.waves`` and
    ``Beamformer.assemble``; a program without that path (no
    ``Stitcher.waves``) is refused at once, before any session is made;
  * a traced run's benchmark spans wrap ``separator.separate``,
    ``stitcher.waves`` and ``beamformer.assemble`` (the ``separator``,
    ``stitcher`` and ``beamformer`` spans the ``.sep`` readers read);
  * the reference is the configuration's model reference
    (``reference/conv_tasnet.py``: ``streams``) inside its pipeline
    reference (``reference/separation_wave.py``), float32, TF32 off;
  * the model's operations are counted at the encoder's frames a window,
    (win - L) / (L / 2) + 1, 4,831 for a 2.4 s window.

``errors``, ``make_pool`` and ``ELEM`` are the separation driver's,
loaded from the same checkout; the limits are the configuration's under
``separation_wave``.

``TINY``: the overrides that cut this driver's cells to a CPU test's
size (both the widths and ``program_conf``).
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np
import torch

from bench_gpu.harness import manifest, readers
from bench_gpu.harness.setup import (Launches, Outcome, Reservoir, free,
                                     memory_peak, pipeline_reference,
                                     program_model, reference, weights_for)
from bench_gpu.reference.precision import strict_float32

# the separation driver of this checkout: errors, make_pool, ELEM
SEP = manifest.driver_module("separation",
                             Path(__file__).resolve().parents[2])
LIMITS = "separation_wave"

TINY = {
    "config": {"widths": {"num_filters": 32, "bottleneck_channels": 16,
                          "conv_channels": 32, "num_blocks": 3,
                          "num_layers": 1},
               "program_conf": {"conv_tasnet_num_filters": 32,
                                "conv_tasnet_bottleneck_channels": 16,
                                "conv_tasnet_conv_channels": 32,
                                "conv_tasnet_num_blocks": 3,
                                "conv_tasnet_num_layers": 1,
                                "bf16": False}},
    "traffic": {"session": {"seconds": 5}, "pool": 2,
                "warm_sessions": 1, "check_sessions": 2}}


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
        lambda wins: ref.streams(p, wins, widths, mode=mode),
        config["pipeline"], widths["num_spk"])


def judge(config: Dict, seed: int, sample, pool, device, mode: str = "f32",
          root: Path = manifest.ROOT) -> List[Dict[str, float]]:
    """The numbers compared, one dict a drawn session of ``sample``
    [(pool index, streams)]."""
    frame = int(config["pipeline"]["separation"]["frame_length"])
    p = weights_for(config, seed, device, root)
    return [SEP.errors(outs, reference_streams(config, p, pool[i], device,
                                               mode, root), frame)
            for i, outs in sample]


def run(cell, seed: int, seconds: float, device, tracer, t0: float,
        hooks: Dict) -> Outcome:
    from css_tpu_torch.executor.pipeline import CssPipeline

    cfg, traffic = cell.config, cell.traffic
    model = program_model(cfg, seed, device, cell.root)
    pipe = CssPipeline(model, cfg["pipeline"], device=device)
    if not hasattr(pipe.stitcher, "waves"):
        raise RuntimeError("the program has no time-domain separation path "
                           "(no Stitcher.waves)")
    pool = SEP.make_pool(traffic, seed, device)
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
        pipe.stitcher.waves = tracer.wrap(pipe.stitcher.waves, "stitcher")
        pipe.beamformer.assemble = tracer.wrap(pipe.beamformer.assemble,
                                               "beamformer")
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

    limits = cfg["limits"][LIMITS]
    judged = judge(cfg, seed, sample.items, pool, device, root=cell.root)
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
    launches with the shape each cost file gives them at this cell's
    geometry (none of the port's kernels runs on this path today)."""
    sep = pipe.separator
    cfg = cell.config
    length = int(cfg["widths"]["filter_length"])
    n = pool[0].shape[-1]
    total = max(n, sep.win)
    windows = max(1, -(-(total - sep.win) // sep.hop) + 1)
    geo = {"batch": sep.batch_size, "win": sep.win, "hop": sep.hop,
           "frames": (sep.win - length) // (length // 2) + 1,
           "windows": windows, "batches": -(-windows // sep.batch_size),
           "samples": n, "channels": 1, "streams": pipe.num_spk,
           "elem": SEP.ELEM[cfg["dtype"]]}
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
