"""The host blocks the separated streams come back through
(``css_tpu_torch/executor/host_blocks.py``), on the CPU: the pool is
exercised directly with CPU tensors, where its blocks are plain host
memory (pinning needs a card). What it returns equals the streams; what a
caller holds is never overwritten; a freed block is reused, a short one
replaced; with every block held the copy falls back to the pageable path.
And the benchmark's reader of its counters (``to_host_reuse.sep``)."""

import numpy as np
import pytest
import torch

from bench_gpu.harness import manifest, readers
from bench_gpu.harness.trace import Tracer
from css_tpu_torch.executor.host_blocks import BLOCKS, HostBlocks
from css_tpu_torch.utils import trace

N = 4000


def _streams(k, seed, n=N + 37):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(n, generator=g) for _ in range(k)]


def _session(pool, streams, n=N):
    """The pool's copy of one session and the counters it took."""
    trace.collect()
    with trace.recording():
        outs = pool.to_host(streams, n)
    return outs, trace.collect()["counters"]


@pytest.mark.parametrize("k", [2, 3])
def test_returned_arrays_equal_the_streams(k):
    pool = HostBlocks()
    for seed in range(3):
        streams = _streams(k, seed)
        outs, _ = _session(pool, streams)
        assert len(outs) == k
        for o, s in zip(outs, streams):
            assert isinstance(o, np.ndarray) and o.dtype == np.float32
            assert o.shape == (N,) and o.flags.c_contiguous
            assert np.array_equal(o, s[:N].numpy())


# ways a caller may keep a session's stream, and where what it keeps starts
HOLD = {"arrays": (lambda o: o, 0), "slices": (lambda o: o[10:], 10),
        "tensors": (lambda o: torch.from_numpy(o[5:]), 5)}


@pytest.mark.parametrize("keep", list(HOLD))
def test_held_arrays_survive_later_sessions(keep):
    """However a caller keeps session 1's streams, sessions 2-5 do not
    write into them."""
    hold, off = HOLD[keep]
    pool = HostBlocks()
    first = _streams(2, 1)
    outs, _ = _session(pool, first)
    kept = [hold(o) for o in outs]
    del outs
    for seed in range(2, 6):
        _session(pool, _streams(2, seed))  # dropped at once
    for got, s in zip(kept, first):
        assert np.array_equal(np.asarray(got), s[off:N].numpy())


def test_a_dropped_block_is_reused():
    pool = HostBlocks()
    outs, c = _session(pool, _streams(2, 1))
    assert c == {"to_host_pinned": 1}
    where = outs[0].ctypes.data
    del outs
    streams = _streams(2, 2)
    outs, c = _session(pool, streams)
    assert c == {"to_host_reused": 1}
    assert outs[0].ctypes.data == where
    assert np.array_equal(outs[1], streams[1][:N].numpy())
    del outs
    outs, c = _session(pool, _streams(2, 3), n=N // 2)  # a shorter one
    assert c == {"to_host_reused": 1} and outs[0].shape == (N // 2,)


def test_a_longer_session_replaces_a_short_free_block():
    pool = HostBlocks()
    outs, _ = _session(pool, _streams(2, 1, n=N))
    del outs
    streams = _streams(2, 2, n=2 * N)
    outs, c = _session(pool, streams, n=2 * N)
    assert c == {"to_host_pinned": 1}
    assert len(pool._blocks) == 1  # replaced, not added
    assert np.array_equal(outs[0], streams[0].numpy())


def test_with_every_block_held_the_copy_falls_back():
    pool = HostBlocks()
    held = [_session(pool, _streams(2, seed))[0] for seed in range(BLOCKS)]
    assert len(pool._blocks) == BLOCKS
    streams = _streams(2, 99)
    outs, c = _session(pool, streams)
    assert c == {"to_host_pageable": 1}
    assert len(pool._blocks) == BLOCKS  # nothing more pinned
    for o, s in zip(outs, streams):
        assert o.dtype == np.float32 and np.array_equal(o, s[:N].numpy())
    for seed, kept in enumerate(held):  # the held ones are intact
        for o, s in zip(kept, _streams(2, seed)):
            assert np.array_equal(o, s[:N].numpy())
    del held[2]
    outs, c = _session(pool, _streams(2, 100))
    assert c == {"to_host_reused": 1}


def _record(counters):
    tracer = Tracer(True, torch.device("cpu"))
    tracer.program = {"spans": {}, "counters": counters}
    return readers.Record(tracer=tracer, config={}, counts={"sessions": 9})


@pytest.mark.parametrize("counters,want", [
    ({"sessions": 8}, None),  # a program without the pool
    ({"sessions": 8, "to_host_reused": 6, "to_host_pinned": 2}, 75.0),
    ({"sessions": 4, "to_host_pinned": 3, "to_host_pageable": 1}, 0.0)])
def test_the_reuse_reader(counters, want):
    rec = _record(counters)
    got = manifest.reader("to_host_reuse.sep")(rec)
    assert got == want
    assert bool(rec.why) == (want is None)  # a reason for None alone
