"""Milliseconds a session in the beamformer's span (the benchmark's span around
the pipeline's beamformer call, ended by a synchronise)."""

from bench_gpu.harness.readers import span_ms


def read(rec):
    return span_ms(rec, "beamformer", "sessions")
