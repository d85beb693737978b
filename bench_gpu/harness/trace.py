"""The traced run: the benchmark's own spans around calls into the
program, and the device's timeline from ``torch.profiler``.

``Tracer(enabled)``: with tracing off every method is a no-op, so the
untraced run times the program alone. With it on:

  * ``span(name)`` times a block on the host clock (ended by a
    synchronise where ``sync``) and marks it in the profiler's timeline
    as ``bench.<name>``;
  * ``window()`` brackets the traced window: the profiler (CPU and CUDA
    activities) runs over it with the program's own spans and counters
    recording (``css_tpu_torch.utils.trace.recording()``; nothing where
    the program has none), and at its close the device's operations
    (kernels, copies, sets) inside it are read from the profiler's raw
    records, without building its event tree.

Then the tracer holds what the metric readers read: the window's length,
the union of device intervals (``busy_s``), the device time and count of
every operation by name (``ops``), the device time charged to the chain
of the program's spans that launched it (``charged``,
``harness/spans.py``), the idle gaps between device intervals put down to
the innermost span of either kind the host was in (``gaps``), the
benchmark's spans' durations (``spans``) and what the program recorded
(``program``: ``trace.collect()``, its spans' totals and its counters).
The device-side marks of either kind of span are not device work.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

from bench_gpu.harness.spans import BENCH, charge, gap_labels, split

NAME_CHARS = 160  # a device operation's name as the breakdown gives it


def _record_function(name: str):
    from torch.profiler import record_function

    return record_function(BENCH + name)


class Tracer:
    def __init__(self, enabled: bool, device: torch.device):
        self.enabled = bool(enabled)
        self.device = device
        self.spans: Dict[str, List[float]] = defaultdict(list)
        self.window_s: Optional[float] = None
        self.busy_s: Optional[float] = None
        self.ops: Dict[str, List[float]] = {}  # name -> [seconds, count]
        self.gaps: Dict[str, float] = {}
        self.charged: Dict[str, float] = {}
        self.program: Optional[Dict] = None
        self.note: Optional[str] = None
        self._prof = None

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def span(self, name: str, sync: bool = False):
        if not self.enabled:
            yield
            return
        with _record_function(name):
            t = time.perf_counter()
            try:
                yield
            finally:
                if sync:
                    self._sync()
                self.spans[name].append(time.perf_counter() - t)

    def wrap(self, fn, name: str, sync: bool = True):
        """``fn`` run inside ``span(name, sync)``."""
        def timed(*args, **kwargs):
            with self.span(name, sync):
                return fn(*args, **kwargs)
        return timed

    @contextlib.contextmanager
    def window(self):
        if not self.enabled:
            yield
            return
        from torch.profiler import ProfilerActivity, profile

        try:
            from css_tpu_torch.utils import trace as program
        except ImportError:  # a program that marks no span of its own
            program = None
        recording = (program.recording() if program is not None
                     else contextlib.nullcontext())
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._sync()
        if program is not None:
            program.collect()  # drop whatever was recorded before
        self._prof = profile(activities=acts)
        self._prof.start()
        t = time.perf_counter()
        try:
            with _record_function("window"), recording:
                yield
            self._sync()
        finally:
            self.window_s = time.perf_counter() - t
            self._prof.stop()
        if program is not None:
            self.program = program.collect()
        self._collect()
        self._prof = None

    def _collect(self) -> None:
        marks, runtime, launched, device, window = split(
            self._prof.profiler.kineto_results.events())
        if window is None:
            self.note = "the profiler recorded no window marker"
            return
        lo, hi = window
        ops: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
        inside = []
        for s, e, _, _, name in device:
            if e > lo and s < hi:
                inside.append((max(s, lo), min(e, hi)))
                rec = ops[name[:NAME_CHARS]]
                rec[0] += (e - s) * 1e-9
                rec[1] += 1
        inside.sort()
        if not inside:
            self.note = "the profiler recorded no device time in the window"
            return
        merged = [list(inside[0])]
        for s, e in inside[1:]:
            if s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        self.busy_s = sum(e - s for s, e in merged) * 1e-9
        self.ops = dict(ops)
        gaps = [(lo, merged[0][0])] + [
            (a[1], b[0]) for a, b in zip(merged, merged[1:])] + [
            (merged[-1][1], hi)]
        self.charged = charge(device, runtime, launched, marks, lo, hi)
        self.gaps = gap_labels(gaps, marks)

    def kernel(self, symbol: str) -> Tuple[float, int]:
        """(device seconds, count) of the operations whose name holds
        ``symbol``."""
        secs = count = 0
        for name, (s, n) in self.ops.items():
            if symbol in name:
                secs += s
                count += n
        return secs, count

    def breakdown(self, top: int = 10) -> Dict:
        ops = sorted(self.ops.items(), key=lambda kv: -kv[1][0])[:top]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n, s] for n, (s, _) in ops],
                "idle_gaps": [[n, s] for n, s in gaps]}
