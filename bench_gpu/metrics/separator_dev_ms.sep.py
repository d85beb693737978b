"""Device milliseconds a session launched under the program's
``css.separator`` span: the separator's batches: K3, the model's graph
replays (KC inside the Conformer's), the padding and the final
concatenation. From the device trace, each operation charged to the span
open on the host when it was launched (``harness/spans.py``)."""

from bench_gpu.harness.readers import device_ms


def read(rec):
    return device_ms(rec, "separator", "sessions")
