"""Spans and counters at the port's layer boundaries, off by default.

``span(name, **attrs)`` marks a block of host work; ``count(name, n)``
adds to a counter. Both read one module-level flag first: with tracing
off ``span`` hands back one shared no-op context and ``count`` returns,
so the instrumented path reads no clock, allocates no span and enters no
profiler mark.

``recording()`` switches tracing on for a block. A span then records its
name, its host start and end (``time.perf_counter_ns``), its parent (the
innermost span open on the same thread), the id of the ``session`` span
it falls under (spans of one recording share it) and its attributes, and
enters ``torch.profiler.record_function("css." + name)``, so that a
running profiler places it on the clock of its device events. No span
synchronises the device: a span's times are the host's, and a stage's
device time is the profiler's to give.

What is recorded stays in memory until ``collect()`` returns and clears
it: a per-name aggregate (count, total and self nanoseconds; a span's
self time is its duration less its children's), the counters, and at
most ``MAX_SPANS`` raw spans, past which the spans are counted as
dropped, so a long traced run grows no further.

The spans of the separation path (``css.`` prefix in a profile):
``session`` (``executor/pipeline.py``; attribute ``audio_s``) with
``upload``, ``separator`` (``executor/separator.py``) and its
``program.<name>`` calls (``utils/programs.py``; attribute ``kind``:
``eager``, ``capture``, ``replay`` or ``direct``), ``stitcher`` with
``stitcher.scan`` (``executor/stitcher.py``; a time-domain model's
``stitcher`` holds ``stitcher.wave``, the boundary costs and the routing,
with ``stitcher.scan`` inside it), ``beamformer``
(``executor/beamformer.py``; under Souden MVDR it holds
``beamformer.mvdr``, and that ``beamformer.stft``, ``beamformer.scm``,
``beamformer.solve`` and ``beamformer.apply``), ``to_host`` and
``reanchor``. Counters: ``sessions``, ``audio_samples``, ``bytes_up``,
``windows``, ``batch_slots``, ``bytes_down``; on a CUDA device, under
``to_host`` (``executor/host_blocks.py``), ``to_host_reused``,
``to_host_pinned`` and ``to_host_pageable``; with the DOA merge
``merge_windows`` and ``merge_kills``; under Souden MVDR
``mvdr_systems``; for a time-domain model ``stitch_swaps`` (the
boundaries whose permutation is not the identity, counted from the
scan's host copy).
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import Dict, List, Optional

from torch.profiler import record_function

PREFIX = "css."
MAX_SPANS = 1 << 16  # raw spans kept between two collect() calls

_ON = False
_LOCK = threading.Lock()
_LOCAL = threading.local()
_IDS = itertools.count(1)


class _Noop:
    """The span handed back while tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NOOP = _Noop()


class _Store:
    def __init__(self):
        self.agg: Dict[str, List[int]] = {}  # name -> [count, total, self]
        self.raw: List[tuple] = []
        self.dropped = 0
        self.counters: Dict[str, int] = {}


_STORE = _Store()


def enabled() -> bool:
    return _ON


@contextlib.contextmanager
def recording():
    """Tracing on inside the block (restored to what it was after)."""
    global _ON
    saved = _ON
    _ON = True
    try:
        yield
    finally:
        _ON = saved


def span(name: str, **attrs):
    """A context that records the block as span ``name`` while tracing is
    on; the shared no-op otherwise."""
    if not _ON:
        return NOOP
    return _Span(name, attrs)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` while tracing is on."""
    if not _ON:
        return
    with _LOCK:
        _STORE.counters[name] = _STORE.counters.get(name, 0) + n


def collect() -> Dict:
    """What was recorded since the last call, and clear it: ``spans``
    (name -> count, total_ns, self_ns), ``counters``, ``raw`` (one dict a
    span, in the order they ended: id, name, parent, session, start_ns,
    end_ns, self_ns, attrs) and ``dropped`` (raw spans past MAX_SPANS)."""
    global _STORE
    with _LOCK:
        store, _STORE = _STORE, _Store()
    keys = ("id", "name", "parent", "session", "start_ns", "end_ns",
            "self_ns", "attrs")
    return {"spans": {k: {"count": c, "total_ns": t, "self_ns": s}
                      for k, (c, t, s) in store.agg.items()},
            "counters": dict(store.counters),
            "raw": [dict(zip(keys, r)) for r in store.raw],
            "dropped": store.dropped}


def _stack() -> list:
    st = getattr(_LOCAL, "stack", None)
    if st is None:
        st = _LOCAL.stack = []
    return st


class _Span:
    __slots__ = ("name", "attrs", "id", "parent", "session", "start",
                 "child_ns", "_mark")

    def __init__(self, name: str, attrs: Dict):
        self.name = name
        self.attrs = attrs

    def __enter__(self):
        st = _stack()
        parent: Optional[_Span] = st[-1] if st else None
        self.id = next(_IDS)
        self.parent = parent.id if parent is not None else None
        self.session = (self.id if self.name == "session" else
                        parent.session if parent is not None else None)
        self.child_ns = 0
        self._mark = record_function(PREFIX + self.name)
        self._mark.__enter__()
        st.append(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        st = _stack()
        st.pop()
        self._mark.__exit__(*exc)
        dur = end - self.start
        if st:
            st[-1].child_ns += dur
        own = dur - self.child_ns
        with _LOCK:
            agg = _STORE.agg.get(self.name)
            if agg is None:
                agg = _STORE.agg[self.name] = [0, 0, 0]
            agg[0] += 1
            agg[1] += dur
            agg[2] += own
            if len(_STORE.raw) < MAX_SPANS:
                _STORE.raw.append((self.id, self.name, self.parent,
                                   self.session, self.start, end, own,
                                   self.attrs))
            else:
                _STORE.dropped += 1
        return False
