"""Milliseconds a session in the separator's span (the benchmark's span around
the pipeline's separator call, ended by a synchronise)."""

from bench_gpu.harness.readers import span_ms


def read(rec):
    return span_ms(rec, "separator", "sessions")
