"""Device milliseconds a session launched under the program's
``css.to_host`` span: the copy of the session's streams to the host (the
device to pageable host memory). From the device trace, each operation
charged to the span open on the host when it was launched
(``harness/spans.py``)."""

from bench_gpu.harness.readers import device_ms


def read(rec):
    return device_ms(rec, "to_host", "sessions")
