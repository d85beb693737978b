"""Device time and idle gaps put down to the program's own spans.

The program marks its spans in the profiler's timeline as ``css.<name>``
(``css_tpu_torch/utils/trace.py``, while ``trace.recording()`` is on);
the benchmark marks its own as ``bench.<name>`` (``harness/trace.py``).
From a profile's raw events:

  * ``split(events)``: the host marks of either prefix, the host start
    of every runtime call by its correlation id (``cudaLaunchKernel``,
    ``cudaLaunchKernelExC``, ``cudaGraphLaunch``, ``cudaMemcpyAsync``,
    ...: every CPU event whose name begins ``cu``), the host start of
    every other CPU event (the PyTorch ops) by its correlation id, the
    device operations with their correlation and linked ids and names, and
    the benchmark's window; the device-side entries of the marks are not
    device operations;
  * ``charge(...)``: each device operation's seconds, clipped to the
    window, put down to the chain of ``css.`` spans open on the host when
    it was launched. The launch is the runtime call that shares the
    operation's correlation id (a CUDA graph's kernels share their
    ``cudaGraphLaunch``'s, so a replay's kernels go to the span that
    replayed them), else the PyTorch op its linked id names. Keys are the
    chain's names joined by ``/``, outermost first; ``""`` an operation
    launched outside every ``css.`` span, ``UNLAUNCHED`` one whose launch
    the profile does not hold;
  * ``gap_labels(...)``: each idle gap's seconds put down to what the
    host was in over the gap, instant by instant: the innermost mark of
    either prefix open then. A ``css.`` mark keeps its prefix
    (``css.stitcher.scan``), a ``bench.`` mark is named without it as
    before (``separator``), no mark is ``harness``. A gap that outlasts a
    span (the device idle from a copy's end to the next session's first
    launch) is split between the spans it crosses.

Marks of one thread nest; a mark's chain holds the marks open at the
point, so a point in a ``bench.`` span and in the ``css.`` span inside it
has both.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, Iterable, List, Sequence, Tuple

CSS = "css."
BENCH = "bench."
WINDOW = BENCH + "window"
UNLAUNCHED = "unlaunched"

Mark = Tuple[int, int, str]  # host start, end (ns), full name


def split(events: Iterable):
    """Raw profiler events, read once -> (marks, runtime {corr: start_ns},
    ops {corr: start_ns}, device [(start_ns, end_ns, corr, linked,
    name)], window (start_ns, end_ns) of the ``bench.window`` mark or
    None)."""
    marks: List[Mark] = []
    runtime: Dict[int, int] = {}
    ops: Dict[int, int] = {}
    device = []
    window = None
    on_host: Dict[object, bool] = {}  # device type -> is the CPU
    for e in events:
        name = e.name()
        kind = e.device_type()
        host = on_host.get(kind)
        if host is None:
            host = on_host[kind] = str(kind).endswith("CPU")
        start = e.start_ns()
        if host:
            if name.startswith((CSS, BENCH)):
                if name == WINDOW:
                    window = (start, start + e.duration_ns())
                else:
                    marks.append((start, start + e.duration_ns(), name))
            elif name.startswith("cu"):
                runtime[e.correlation_id()] = start
            else:
                ops[e.correlation_id()] = start
            continue
        dur = e.duration_ns()
        if dur <= 0 or name.startswith((CSS, BENCH)):
            continue  # the marks' own entries on the device's timeline
        device.append((start, start + dur, e.correlation_id(),
                       e.linked_correlation_id(), name))
    return marks, runtime, ops, device, window


def chains(marks: Sequence[Mark], points: Sequence[int]
           ) -> List[Tuple[str, ...]]:
    """The names of the marks open at each point (start <= t <= end),
    outermost first."""
    order = sorted(marks, key=lambda m: (m[0], -m[1]))
    out: List[Tuple[str, ...]] = [()] * len(points)
    stack: List[Mark] = []
    j, last = 0, None
    for i in sorted(range(len(points)), key=points.__getitem__):
        t = points[i]
        if t == last:  # a graph replay's kernels share their launch
            out[i] = out[prev]
            continue
        last, prev = t, i
        while j < len(order) and order[j][0] <= t:
            # a mark that ended before this one began is left (marks of
            # one thread nest), so the stack stays as deep as the nesting
            while stack and stack[-1][1] < order[j][0]:
                stack.pop()
            stack.append(order[j])
            j += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out[i] = tuple(m[2] for m in stack if m[1] >= t)
    return out


def charge(device, runtime: Dict[int, int], ops: Dict[int, int],
           marks: Sequence[Mark], lo: int, hi: int) -> Dict[str, float]:
    """Seconds of device time inside [lo, hi] by the chain of ``css.``
    spans open at each operation's launch."""
    css = [m for m in marks if m[2].startswith(CSS)]
    inside, points = [], []
    for s, e, corr, linked, _ in device:
        if e <= lo or s >= hi:
            continue
        t = runtime.get(corr, ops.get(linked) if linked else None)
        inside.append((max(s, lo), min(e, hi), t))
        points.append(t if t is not None else 0)
    out: Dict[str, float] = defaultdict(float)
    keys: Dict[Tuple[str, ...], str] = {}
    for (s, e, t), chain in zip(inside, chains(css, points)):
        if t is None:
            key = UNLAUNCHED
        else:
            key = keys.get(chain)
            if key is None:
                key = keys[chain] = "/".join(n[len(CSS):] for n in chain)
        out[key] += (e - s) * 1e-9
    return dict(out)


def _label(chain: Tuple[str, ...]) -> str:
    if not chain:
        return "harness"
    inner = chain[-1]
    return inner if inner.startswith(CSS) else inner[len(BENCH):]


def gap_labels(gaps: Sequence[Tuple[int, int]], marks: Sequence[Mark]
               ) -> Dict[str, float]:
    """Seconds of the gaps by the innermost mark open over each instant."""
    # the marks' ends cut the timeline into pieces, each with one
    # innermost mark; a gap takes its overlap with every piece
    cuts = sorted({t for m in marks for t in m[:2]})
    labels = [_label(c) for c in chains(
        marks, [(a + b) // 2 for a, b in zip(cuts, cuts[1:])])]
    out: Dict[str, float] = defaultdict(float)
    for s, e in gaps:
        if e <= s:
            continue
        if not cuts or e <= cuts[0] or s >= cuts[-1]:
            out["harness"] += (e - s) * 1e-9
            continue
        out["harness"] += (max(0, cuts[0] - s) + max(0, e - cuts[-1])) * 1e-9
        j = max(0, bisect.bisect_right(cuts, s) - 1)
        while j < len(labels) and cuts[j] < e:
            lo, hi = max(s, cuts[j]), min(e, cuts[j + 1])
            if hi > lo:
                out[labels[j]] += (hi - lo) * 1e-9
            j += 1
    return {k: v for k, v in out.items() if v > 0}


def under(charged: Dict[str, float], span: str) -> float:
    """Seconds charged to ``span`` or any span inside it."""
    return sum(v for k, v in charged.items() if span in k.split("/"))
