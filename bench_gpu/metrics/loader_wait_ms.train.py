"""Milliseconds a step the trainer blocked in the loader's ``__next__``
(the benchmark's span around each pull)."""

from bench_gpu.harness.readers import span_ms


def read(rec):
    return span_ms(rec, "loader_wait", "steps")
