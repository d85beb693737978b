"""What a per-layer metric's reader reads, and the arithmetic the readers
share.

A ``Record`` holds one traced run: its ``tracer`` (the benchmark's spans,
the device's timeline, the device time charged to the program's spans
and what the program recorded: ``harness/trace.py``), ``counts`` taken by
the driver over the window (sessions, steps, kernel launches, model
operations), ``work`` (kernel -> list of (launches, shape) pairs the
driver knows from the cell's shapes) and the configuration. A reader
returns a number or None, never a 0 that stands for "not seen"; ``why``
collects the reasons for each None.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from bench_gpu.costs import peaks
from bench_gpu.harness import manifest, spans


@dataclass
class Record:
    tracer: object
    config: Dict
    counts: Dict[str, float] = field(default_factory=dict)
    work: Dict[str, List[Tuple[int, Dict]]] = field(default_factory=dict)
    why: List[str] = field(default_factory=list)
    root: Path = manifest.ROOT
    # kernel -> the wrapper its cost file names and the program lacks
    missing: Dict[str, str] = field(default_factory=dict)


def kernel_roofline(rec: Record, kernel: str) -> Optional[float]:
    """Percent: the least time the kernel's launches in the window could
    take (costs/<kernel>.py) over their device time in the trace. Absent
    where the program lacks the kernel, the window launched none or the
    cell gives it no shape, or the trace does not show each launch (a CUDA
    graph whose kernels the profiler does not see)."""
    if kernel in rec.missing:
        rec.why.append(f"{kernel}: the program has no {rec.missing[kernel]}")
        return None
    pairs = rec.work.get(kernel) or []
    launches = sum(n for n, _ in pairs)
    if launches == 0:
        rec.why.append(f"{kernel}: no launch in the window")
        return None
    mod = manifest.cost(kernel, rec.root)
    secs, seen = rec.tracer.kernel(mod.NAME)
    if seen != launches:
        rec.why.append(f"{kernel}: the trace shows {seen} of {launches} "
                       f"launches of {mod.NAME}")
        return None
    bound = sum(n * mod.bound_seconds(**shape) for n, shape in pairs)
    return 100.0 * bound / secs


def idle_share(rec: Record) -> Optional[float]:
    """Percent of the traced window in which no device operation ran."""
    t = rec.tracer
    if t.busy_s is None or not t.window_s:
        rec.why.append(f"idle share: {t.note}")
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def mfu(rec: Record) -> Optional[float]:
    """Percent: the model operations of the window's work over the
    window's wall time over the configuration dtype's peak."""
    flops = rec.counts.get("model_flops")
    if not flops or not rec.tracer.window_s:
        rec.why.append("mfu: no model work in the window")
        return None
    peak = peaks.MODEL_PEAK[rec.config["dtype"]]
    return 100.0 * flops / rec.tracer.window_s / peak


def span_ms(rec: Record, name: str, per: str) -> Optional[float]:
    """The span's total milliseconds over the count ``per``."""
    spans = rec.tracer.spans.get(name)
    n = rec.counts.get(per)
    if not spans or not n:
        rec.why.append(f"{name}: no span in the window")
        return None
    return 1e3 * sum(spans) / n


def device_ms(rec: Record, span: str, per: str) -> Optional[float]:
    """Device milliseconds launched under the program's span ``css.<span>``
    (the spans inside it included) over the count ``per``."""
    seconds = spans.under(rec.tracer.charged, span)
    n = rec.counts.get(per)
    if not seconds or not n:
        rec.why.append(f"{span}: no device time charged to css.{span}")
        return None
    return 1e3 * seconds / n


def program_ms(rec: Record, span: str, per: str) -> Optional[float]:
    """The host milliseconds of the program's span ``css.<span>`` (its
    total over the window) over the count ``per``."""
    got = (rec.tracer.program or {}).get("spans", {}).get(span)
    n = rec.counts.get(per)
    if not got or not n:
        rec.why.append(f"{span}: the program recorded no css.{span}")
        return None
    return 1e-6 * got["total_ns"] / n


def counter(rec: Record, name: str) -> Optional[float]:
    """The program's counter ``name`` over the window."""
    got = (rec.tracer.program or {}).get("counters", {}).get(name)
    if got is None:
        rec.why.append(f"{name}: the program counted nothing")
        return None
    return got
