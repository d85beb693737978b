"""Device milliseconds a session launched under the program's
``css.upload`` span: the copy of the session's recording to the card
(pageable host memory to the device). From the device trace, each
operation charged to the span open on the host when it was launched
(``harness/spans.py``)."""

from bench_gpu.harness.readers import device_ms


def read(rec):
    return device_ms(rec, "upload", "sessions")
