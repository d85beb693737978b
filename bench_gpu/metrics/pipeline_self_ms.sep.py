"""Milliseconds a session spent in the pipeline's own work (upload,
padding, the copy of the streams to the host): the session's span less
its separator, stitcher and beamformer spans."""

from bench_gpu.harness.readers import span_ms


def read(rec):
    parts = [span_ms(rec, n, "sessions")
             for n in ("session", "separator", "stitcher", "beamformer")]
    if any(p is None for p in parts):
        return None
    return parts[0] - sum(parts[1:])
