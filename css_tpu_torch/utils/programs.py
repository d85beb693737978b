"""Fixed-shape step functions as captured CUDA graphs: the port's
counterpart of ``jax.jit``.

``css_tpu`` runs each fixed-shape step (the separator's batch forward,
the hop-mode chunk step, the train and eval steps, G train steps at
once) as one compiled device program. On the card the counterpart is a
CUDA graph: one replay launches the step's thousands of kernels with one
host call. ``Program(fn, name)`` wraps a step function:

  * a cache keyed by the inputs' tree structure, their shapes, dtypes
    and device, the non-tensor arguments, the caller's ``mode``, and
    what the graph bakes in: the TF32 switches and the grad mode (a
    measurement that swaps a kernel wrapper for its plain version runs
    its programs under ``eager()``, so no graph holds a swapped wrapper);
  * the first call of a key runs ``fn`` eagerly. That is real work, never
    an extra step: it builds the kernels, fills the wrappers' table
    caches and lets cuBLAS pick its algorithms, none of which may happen
    inside a capture. The second call captures ``fn`` on copies of its
    inputs (static buffers), then replays it; every later call copies
    its inputs into the static buffers and replays;
  * outputs come back as clones, so a later replay (of this graph or of
    one that shares its memory pool) never overwrites what a caller
    holds. The graphs of one ``Program`` share one pool: no static output
    is read after another replay;
  * a capture that fails raises and names its key: there is no route back
    to eager dispatch;
  * a capture records nothing on the card, so whatever ``fn`` mutates
    (parameters, carried state) moves only when the graph replays.
    ``fn`` keeps its state on the card and reads none to the host.

Launch counters. A kernel wrapper counts its launches on the host, once
a call, so a capture would count them once and a replay never. A capture
records the delta of every counter registered in ``ops/_build.py``
(``KERNELS``), takes it back (the capture launched nothing), and every
replay adds it, so ``launches`` still counts the launches the card
executed.

On the CPU (tensors on the CPU) ``fn`` runs directly: the CPU route, as
the kernels' plain versions are. ``eager()`` makes every program run
its function directly on the card too: for measurements that compare a
program with eager dispatch, never a fallback.

``report()`` lists what every live program holds: its captures, their
seconds, the seconds of its keys' first eager calls, the bytes its
graphs' pool holds on the card, and its replays; ``build_seconds()``
the seconds every program of the process, freed ones too, spent in
first calls and captures (host time: neither synchronises).

Every call is a ``program.<name>`` span (``utils/trace.py``), its
``kind`` ``eager`` (a key's first call), ``capture`` (its second, which
captures and replays), ``replay`` or ``direct`` (the function run
directly: on the CPU, or under ``eager()``).
"""

from __future__ import annotations

import contextlib
import gc
import time
import weakref
from typing import Callable, Dict, List, Tuple

import torch
from torch.utils import _pytree as pytree

from css_tpu_torch.ops import _build
from css_tpu_torch.utils import trace

_PROGRAMS = weakref.WeakSet()
_EAGER = [False]
_BUILD_S = [0.0]  # first calls and captures of every program, in seconds


def _counts() -> Dict[str, Tuple[int, int]]:
    return {name: (fn.launches, fn.plain_routes)
            for name, fn in _build.KERNELS.items()}


def _add_counts(deltas: Dict[str, Tuple[int, int]]) -> None:
    for name, (launches, routes) in deltas.items():
        fn = _build.KERNELS[name]
        fn.launches += launches
        fn.plain_routes += routes


@contextlib.contextmanager
def eager():
    """Run every program's function directly, on the card as on the CPU:
    for measurements of a program against eager dispatch, and for runs
    that swap a kernel wrapper for its plain version (a graph would
    replay the kernels it captured, whatever the wrapper now is)."""
    saved = _EAGER[0]
    _EAGER[0] = True
    try:
        yield
    finally:
        _EAGER[0] = saved


def report() -> List[Dict]:
    """Every live program's ``summary()``."""
    return sorted((p.summary() for p in _PROGRAMS), key=lambda s: s["name"])


def build_seconds() -> float:
    """Host seconds of every key's first eager call and capture, over
    every program this process has made."""
    return _BUILD_S[0]


class _Entry:
    """One key's graph: its static inputs and outputs, the counters'
    deltas of one replay, what its capture cost, and its replays."""

    def __init__(self, graph, static, out, deltas, capture_s):
        self.graph, self.static, self.out = graph, static, out
        self.deltas = deltas
        self.capture_s = capture_s
        self.replays = 0


def _clone(x):
    return x.clone() if isinstance(x, torch.Tensor) else x


class Program:
    """``fn(*args)`` on fixed shapes: eager on the first call of a key,
    captured on the second, replayed after; ``fn`` directly on the CPU.

    ``args`` is any tree (tuples, lists, dicts) of tensors and hashable
    constants; the constants are part of the key. ``generators``: the
    ``torch.Generator``s that ``fn`` draws from besides the default one,
    registered with each graph so that every replay draws afresh."""

    def __init__(self, fn: Callable, name: str, generators=()):
        self.fn = fn
        self.name = name
        self.generators = tuple(generators)
        self._entries: Dict[tuple, object] = {}
        self._first_s: Dict[tuple, float] = {}
        self._pool = None
        self._span = "program." + name
        _PROGRAMS.add(self)

    def key(self, leaves, spec, mode) -> tuple:
        sig = tuple((tuple(x.shape), x.dtype, x.device)
                    if isinstance(x, torch.Tensor) else ("const", x)
                    for x in leaves)
        return (str(spec), sig, mode,
                torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32, torch.is_grad_enabled())

    def __call__(self, *args, mode=()):
        leaves, spec = pytree.tree_flatten(args)
        dev = next((x.device for x in leaves if isinstance(x, torch.Tensor)),
                   None)
        if dev is None or dev.type != "cuda" or _EAGER[0]:
            with trace.span(self._span, kind="direct"):
                return self.fn(*args)
        key = self.key(leaves, spec, mode)
        entry = self._entries.get(key, False)
        if entry is False:  # the first call: real work, eagerly
            self._entries[key] = None
            with trace.span(self._span, kind="eager"):
                t = time.perf_counter()
                out = self.fn(*args)
                self._first_s[key] = time.perf_counter() - t
            _BUILD_S[0] += self._first_s[key]
            return out
        with trace.span(self._span,
                        kind="capture" if entry is None else "replay"):
            if entry is None:
                entry = self._entries[key] = self._capture(key, leaves,
                                                           spec)
                _BUILD_S[0] += entry.capture_s
            else:
                for dst, src in zip(entry.static, leaves):
                    if isinstance(src, torch.Tensor) and src is not dst:
                        dst.copy_(src, non_blocking=True)
            entry.graph.replay()
            entry.replays += 1
            _add_counts(entry.deltas)
            return pytree.tree_map(_clone, entry.out)

    def _capture(self, key, leaves, spec) -> _Entry:
        static = [x.detach().clone() if isinstance(x, torch.Tensor) else x
                  for x in leaves]
        graph = torch.cuda.CUDAGraph()
        for gen in self.generators:
            if not hasattr(graph, "register_generator_state"):
                raise RuntimeError(
                    f"program {self.name}: this torch cannot register a "
                    f"generator with a CUDA graph, so replays would repeat "
                    f"their random draws")
            graph.register_generator_state(gen)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        before = _counts()
        t = time.perf_counter()
        # no garbage collection inside the capture: freeing an earlier
        # tensor there may query the events of its stream uses (pinned
        # host memory's), which a capturing thread may not do
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            # thread_local: the loader's producer threads may pin host
            # memory while the main thread captures
            with torch.cuda.graph(graph, pool=self._pool,
                                  capture_error_mode="thread_local"):
                out = self.fn(*pytree.tree_unflatten(static, spec))
        except Exception as exc:
            raise RuntimeError(f"program {self.name}: the capture of key "
                               f"{key} failed: {exc}") from exc
        finally:
            if collecting:
                gc.enable()
        capture_s = time.perf_counter() - t
        deltas = {}
        for name, (launches, routes) in _counts().items():
            was = before.get(name, (0, 0))
            deltas[name] = (launches - was[0], routes - was[1])
        _add_counts({n: (-d[0], -d[1]) for n, d in deltas.items()})
        return _Entry(graph, static, out, deltas, capture_s)

    def pool_bytes(self) -> int:
        """Bytes of the segments the card's allocator holds for this
        program's graph pool (its snapshot's ``segment_pool_id``)."""
        if self._pool is None:
            return 0
        segments = torch.cuda.memory._snapshot()["segments"]
        return sum(seg["total_size"] for seg in segments
                   if tuple(seg["segment_pool_id"]) == tuple(self._pool))

    def summary(self) -> Dict:
        graphs = [e for e in self._entries.values() if e is not None]
        return {"name": self.name, "keys": len(self._entries),
                "captures": len(graphs),
                "capture_s": sum(e.capture_s for e in graphs),
                "first_s": sum(self._first_s.values()),
                "pool_bytes": self.pool_bytes(),
                "replays": sum(e.replays for e in graphs)}
