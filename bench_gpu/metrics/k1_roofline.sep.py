"""K1's share of its roofline in the traced window (device trace,
costs/k1.py), percent."""

from bench_gpu.harness.readers import kernel_roofline


def read(rec):
    return kernel_roofline(rec, "k1")
