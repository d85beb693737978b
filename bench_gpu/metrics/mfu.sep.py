"""The window's model operations over its wall time over the
configuration dtype's peak, percent."""

from bench_gpu.harness.readers import mfu


def read(rec):
    return mfu(rec)
