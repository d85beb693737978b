"""Device time and idle gaps put down to the program's spans
(``harness/spans.py``) on synthetic profiler events, the tracer's reading
of them (``harness/trace.py``), the readers of the program's spans and
counters, and the program's tracing switched on only in a traced
window."""

import json
from types import SimpleNamespace

import pytest
import torch

from bench_gpu import run
from bench_gpu.harness import manifest, readers, spans
from bench_gpu.harness.trace import Tracer


class Event:
    """The parts of a raw profiler event that ``spans.split`` reads."""

    def __init__(self, name, start, end, device="CPU", corr=0, linked=0):
        self._v = (name, start, end, device, corr, linked)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2] - self._v[1]

    def device_type(self):
        return f"DeviceType.{self._v[3]}"

    def correlation_id(self):
        return self._v[4]

    def linked_correlation_id(self):
        return self._v[5]


def kernel(name, start, end, corr, linked=0):
    return Event(name, start, end, "CUDA", corr, linked)


# a session of the benchmark's span holding the program's: an upload's
# copy, a graph replay of three kernels that outlive their host span, a
# kernel known by its linked PyTorch op alone, the stitcher's scan, the
# copy to the host, a kernel whose launch the profile lost and one
# launched outside every program span
EVENTS = [
    Event("bench.window", 0, 1000),
    Event("bench.session", 0, 1000),
    Event("css.session", 10, 990),
    Event("css.upload", 20, 100),
    Event("cudaMemcpyAsync", 30, 35, corr=1),
    kernel("Memcpy HtoD (Pageable -> Device)", 40, 90, corr=1),
    Event("bench.separator", 100, 600),
    Event("css.separator", 110, 580),
    Event("css.program.separator_forward", 150, 200),
    Event("cudaGraphLaunch", 160, 165, corr=2),
    kernel("k3", 170, 250, corr=2),
    kernel("gemm", 250, 330, corr=2),
    kernel("istft", 330, 400, corr=2),
    Event("aten::cat", 250, 260, corr=77),
    kernel("CatArrayBatchedCopy", 400, 450, corr=3, linked=77),
    Event("css.stitcher", 600, 700),
    Event("css.stitcher.scan", 620, 690),
    Event("css.to_host", 800, 950),
    Event("cudaMemcpyAsync", 805, 806, corr=4),
    kernel("Memcpy DtoH (Device -> Pageable)", 810, 900, corr=4),
    kernel("lost", 950, 960, corr=99),
    Event("cudaLaunchKernel", 995, 996, corr=5),
    kernel("outside", 996, 999, corr=5),
    kernel("after the window", 1000, 1100, corr=5),
]


def test_split_sorts_marks_launches_and_device_operations():
    marks, runtime, ops, device, window = spans.split(EVENTS)
    names = [m[2] for m in marks]
    assert "bench.window" not in names
    assert names.count("css.session") == 1 and "bench.separator" in names
    assert runtime == {1: 30, 2: 160, 4: 805, 5: 995}
    assert ops == {77: 250}
    assert (170, 250, 2, 0, "k3") in device and len(device) == 9
    assert window == (0, 1000)


def test_device_time_goes_to_the_innermost_launching_span():
    marks, runtime, ops, device, _ = spans.split(EVENTS)
    got = spans.charge(device, runtime, ops, marks, 0, 1000)
    want = {"session/upload": 50e-9,
            "session/separator/program.separator_forward": 230e-9,
            "session/separator": 50e-9,
            "session/to_host": 90e-9,
            spans.UNLAUNCHED: 10e-9,
            "": 3e-9}
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k] == pytest.approx(v), k
    assert spans.under(got, "separator") == pytest.approx(280e-9)
    assert spans.under(got, "program.separator_forward") == pytest.approx(
        230e-9)
    assert spans.under(got, "stitcher") == 0
    assert spans.under(got, "session") == pytest.approx(420e-9)


def test_an_operation_is_clipped_to_the_window():
    marks, runtime, ops, device, _ = spans.split(EVENTS)
    got = spans.charge(device, runtime, ops, marks, 200, 300)
    assert got == {"session/separator/program.separator_forward":
                   pytest.approx(100e-9)}


def test_gaps_go_to_the_innermost_span_of_either_prefix():
    """Each instant of a gap goes to the innermost span open then: a gap
    that crosses spans is split between them."""
    marks = spans.split(EVENTS)[0]
    gaps = [(0, 40), (90, 170), (450, 810), (900, 950), (960, 996),
            (999, 1010), (5, 5)]
    got = spans.gap_labels(gaps, marks)
    want = {"session": 10 + 6 + 1, "css.session": 10 + 100 + 30,
            "css.upload": 20 + 10, "separator": 10 + 20,
            "css.separator": 40 + 130, "css.program.separator_forward": 20,
            "css.stitcher": 20 + 10, "css.stitcher.scan": 70,
            "css.to_host": 10 + 50, "harness": 10}
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k] == pytest.approx(v * 1e-9), k
    assert sum(got.values()) == pytest.approx(
        sum(e - s for s, e in gaps) * 1e-9)


def test_without_program_spans_gaps_keep_the_benchmarks_labels():
    """A program that marks no span (one that predates them) gives the
    benchmark's own labels, or ``harness``."""
    marks = [m for m in spans.split(EVENTS)[0] if m[2].startswith("bench.")]
    got = spans.gap_labels([(0, 5), (90, 170), (450, 810), (1000, 1010)],
                           marks)
    assert got == {"session": pytest.approx((5 + 10 + 210) * 1e-9),
                   "separator": pytest.approx((70 + 150) * 1e-9),
                   "harness": pytest.approx(10e-9)}
    assert spans.gap_labels([(0, 10)], []) == {
        "harness": pytest.approx(10e-9)}


def test_chains_hold_every_open_mark_outermost_first():
    marks = [(0, 100, "a"), (10, 50, "b"), (20, 30, "c"), (60, 90, "d")]
    assert spans.chains(marks, [25, 55, 70, 100, 5, 101]) == [
        ("a", "b", "c"), ("a",), ("a", "d"), ("a",), ("a",), ()]


def _record():
    return readers.Record(tracer=None, config={})


def test_program_build_seconds_reader(monkeypatch):
    from css_tpu_torch.utils import programs

    read = manifest.reader("program_build_s.sep")
    monkeypatch.setattr(programs, "_BUILD_S", [0.0])
    rec = _record()
    assert read(rec) is None and "program_build_s" in rec.why[0]
    monkeypatch.setattr(programs, "_BUILD_S", [2.5])
    assert read(_record()) == 2.5
    monkeypatch.delattr(programs, "build_seconds")
    rec = _record()
    assert read(rec) is None and "keeps no build seconds" in rec.why[0]


def _traced(events):
    """A tracer whose profile held ``events``, read as a window closes."""
    tracer = Tracer(True, torch.device("cpu"))
    tracer._prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))
    tracer._collect()
    return tracer


def test_span_marks_on_the_device_are_not_busy():
    """The device-side marks of the program's spans and the benchmark's
    are not device work: busy time is the union of operations alone, each
    charged to the program's span that launched it, and each idle instant
    put down to the innermost span of either kind."""
    marks = [Event("css.separator", 110, 580, "CUDA"),
             Event("css.session", 10, 990, "CUDA"),
             Event("bench.separator", 100, 600, "CUDA")]
    tracer = _traced(EVENTS + marks)
    # 40-90, 170-450, 810-900, 950-960, 996-999 inside [0, 1000]
    assert tracer.busy_s == pytest.approx(433e-9)
    assert not [n for n in tracer.ops if n.startswith(("css.", "bench."))]
    m, runtime, ops, device, _ = spans.split(EVENTS)
    assert tracer.charged == spans.charge(device, runtime, ops, m, 0, 1000)
    assert tracer.gaps == spans.gap_labels(
        [(0, 40), (90, 170), (450, 810), (900, 950), (960, 996),
         (999, 1000)], m)
    assert sum(tracer.gaps.values()) == pytest.approx(567e-9)
    assert tracer.gaps["css.stitcher.scan"] == pytest.approx(70e-9)


NEW_READERS = ["upload_ms.sep", "to_host_ms.sep", "separator_dev_ms.sep",
               "stitcher_dev_ms.sep", "beamformer_dev_ms.sep",
               "batch_fill.sep", "kc_roofline.sep"]


def _bare(counts=None):
    """A record of a traced run in which nothing was recorded."""
    return readers.Record(tracer=Tracer(True, torch.device("cpu")),
                          config={}, counts=counts or {"sessions": 3})


@pytest.mark.parametrize("metric", NEW_READERS)
def test_new_readers_read_none_where_nothing_was_recorded(metric):
    rec = _bare()
    assert manifest.reader(metric)(rec) is None
    assert rec.why


@pytest.mark.parametrize("helper,args", [
    (readers.device_ms, ("upload", "sessions")),
    (readers.program_ms, ("session", "sessions")),
    (readers.counter, ("windows",))])
def test_helpers_read_none_with_a_why(helper, args):
    rec = _bare()
    assert helper(rec, *args) is None
    assert len(rec.why) == 1 and args[0] in rec.why[0]


def test_readers_of_program_spans_and_counters():
    tracer = _traced(EVENTS)
    tracer.program = {"spans": {"session": {"count": 2, "total_ns": 9e6,
                                            "self_ns": 1e6}},
                      "counters": {"windows": 748, "batch_slots": 768}}
    rec = readers.Record(tracer=tracer, config={}, counts={"sessions": 2})
    read = {m: manifest.reader(m)(rec) for m in NEW_READERS}
    assert read["separator_dev_ms.sep"] == pytest.approx(280e-9 * 1e3 / 2)
    assert read["upload_ms.sep"] == pytest.approx(50e-9 * 1e3 / 2)
    assert read["to_host_ms.sep"] == pytest.approx(90e-9 * 1e3 / 2)
    assert read["batch_fill.sep"] == pytest.approx(100 * 748 / 768)
    # no device time charged to the stitcher or beamformer, no KC launch
    assert read["stitcher_dev_ms.sep"] is None
    assert read["beamformer_dev_ms.sep"] is None
    assert read["kc_roofline.sep"] is None
    assert readers.program_ms(rec, "session", "sessions") == 4.5
    assert readers.counter(rec, "windows") == 748


@pytest.mark.parametrize("trace", [0, 1])
def test_program_tracing_is_on_in_a_traced_window_alone(trace, tiny):
    """Seen from inside each call of the pipeline: the program's tracing
    stays off in an untraced run, and in a traced one is on in the window
    alone (the warm calls of set-up run untraced)."""
    from css_tpu_torch.utils import trace as program

    seen = []

    def hook(pipe):
        process = pipe.process

        def watched(wav):
            seen.append(program.enabled())
            return process(wav)
        pipe.process = watched
    over = tiny["separation"]
    over["hooks"] = {"pipeline": hook}
    rc, line, err = run.run_cell("conformer_css16x256.sep_libricss10min",
                                 9, 1.0, bool(trace), device="cpu",
                                 overrides=over)
    assert rc == 0, err
    out = json.loads(line)
    warm = over["traffic"]["warm_sessions"]
    assert len(seen) == warm + out["attempted"]
    assert seen == [False] * warm + [bool(trace)] * out["attempted"]
    assert not program.enabled()
    if trace:
        assert out["metrics"]["batch_fill.sep"]["value"] > 0
