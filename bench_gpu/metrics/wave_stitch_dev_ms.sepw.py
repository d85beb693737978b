"""Device milliseconds a session launched under the program's
``css.stitcher.wave`` span: a time-domain model's boundary permutations
(the distances over the samples neighbouring windows share, the argmin
over the permutation table), the host scan's copies and the gather that
routes the windows. From the device trace, each operation charged to the
span open on the host when it was launched (``harness/spans.py``); None
where the program marks no such span."""

from bench_gpu.harness.readers import device_ms


def read(rec):
    return device_ms(rec, "stitcher.wave", "sessions")
