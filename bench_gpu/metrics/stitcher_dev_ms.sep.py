"""Device milliseconds a session launched under the program's
``css.stitcher`` span: the stitcher: the permutation distances, the
routed masks and their overlap-average. From the device trace, each
operation charged to the span open on the host when it was launched
(``harness/spans.py``)."""

from bench_gpu.harness.readers import device_ms


def read(rec):
    return device_ms(rec, "stitcher", "sessions")
