"""The port's spans and counters (``css_tpu_torch/utils/trace.py``) on
the separation path, on the CPU: off, they cost one flag read and record
nothing; on, ``CssPipeline.process`` records the span tree of one
recording, its counters reckoned from the shapes, and the same streams
as with tracing off."""

import json
import logging
import tracemalloc

import numpy as np
import pytest
import torch

from css_tpu_torch.executor.host_blocks import HostBlocks
from css_tpu_torch.executor.pipeline import CssPipeline
from css_tpu_torch.models import build_model
from css_tpu_torch.utils import trace

SR = 16000
BATCH = 4
CONFIG = {
    "sampling_rate": SR,
    "separation": {"batch_size": BATCH, "eval_hop": 0.8, "eval_win": 2.4,
                   "frame_length": 512, "frame_shift": 256},
    "stitching": {"eval_hop": 0.8, "eval_win": 2.4, "hop_size": 256},
    "beamforming": {"type": "masking", "hop_size": 256, "n_fft": 512,
                    "eval_hop": 0.8, "proceed_margin": 2, "eval_win": 2.4,
                    "wta_thresh": 0.0001},
}
# the children of a session, by parent
TREE = {"upload": "session", "separator": "session",
        "program.separator_forward": "separator", "stitcher": "session",
        "stitcher.scan": "stitcher", "beamformer": "session",
        "to_host": "session", "reanchor": "session"}
# every counter of the separation path
COUNTERS = ["sessions", "audio_samples", "bytes_up", "windows",
            "batch_slots", "bytes_down", "to_host_reused", "to_host_pinned",
            "to_host_pageable", "merge_windows", "merge_kills",
            "mvdr_systems", "stitch_swaps"]
# configs/infer_7ch.yaml's settings (IPD, the DOA merge, Souden MVDR)
CONFIG_7CH = {
    "sampling_rate": SR,
    "separation": dict(CONFIG["separation"], ipd="1,0;2,0;3,0;4,0;5,0;6,0",
                       merge=True, merge_threshold=16),
    "stitching": CONFIG["stitching"],
    "beamforming": dict(CONFIG["beamforming"], type="SoudenMVDRBeamformer"),
}
# Souden MVDR's spans, by parent
MVDR_TREE = {"beamformer.mvdr": "beamformer",
             "beamformer.stft": "beamformer.mvdr",
             "beamformer.scm": "beamformer.mvdr",
             "beamformer.solve": "beamformer.mvdr",
             "beamformer.apply": "beamformer.mvdr"}


def _pipe(reanchor=False):
    torch.manual_seed(0)
    model = build_model("BLSTM", {"blstm_hdim": 16, "blstm_num_layers": 1})
    cfg = dict(CONFIG, stitching=dict(CONFIG["stitching"],
                                      reanchor=reanchor))
    return CssPipeline(model, cfg, device="cpu")


def _recording(seconds=7.3, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(int(seconds * SR)) * 0.1).astype(np.float32)


def _pipe_7ch():
    torch.manual_seed(0)
    model = build_model("Conformer", {
        "idim": 7 * 257, "conformer_attention_dim": 32,
        "conformer_attention_heads": 4, "conformer_linear_units": 64,
        "conformer_num_blocks": 1, "conformer_kernel_size": 7})
    return CssPipeline(model, CONFIG_7CH, device="cpu")


def _recording_7ch(seconds=7.3, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((7, int(seconds * SR))) * 0.1).astype(
        np.float32)


@pytest.fixture(autouse=True)
def _empty_store():
    trace.collect()
    yield
    trace.collect()


def test_off_hands_back_the_shared_noop_and_records_nothing(monkeypatch):
    def boom(*args, **kwargs):
        raise AssertionError("entered with tracing off")

    monkeypatch.setattr(trace, "record_function", boom)
    monkeypatch.setattr(trace, "_Span", boom)
    assert not trace.enabled()
    assert trace.span("session", audio_s=1.0) is trace.NOOP
    assert trace.span("upload") is trace.NOOP
    with trace.span("x") as sp:
        assert sp is trace.NOOP
    trace.count("windows", 3)
    _pipe().process(_recording(3.0))
    rec = trace.collect()
    assert rec == {"spans": {}, "counters": {}, "raw": [], "dropped": 0}


def test_off_path_allocates_nothing_per_span():
    def spans():
        for _ in range(1000):
            with trace.span("program.separator_forward", kind="replay"):
                pass
            trace.count("windows", 32)

    spans()
    tracemalloc.start()
    try:
        tracemalloc.reset_peak()
        spans()
        current, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    assert current == 0 and peak < 1000  # under a byte a call


@pytest.mark.parametrize("reanchor", [False, True])
def test_process_records_the_span_tree(reanchor):
    pipe = _pipe(reanchor)
    wav = _recording()
    with trace.recording():
        pipe.process(wav)
    assert not trace.enabled()
    rec = trace.collect()
    raw = rec["raw"]
    by_id = {r["id"]: r for r in raw}
    names = [r["name"] for r in raw]
    windows = -(-(wav.shape[-1] - pipe.separator.win) // pipe.separator.hop
                ) + 1
    batches = -(-windows // BATCH)
    want = {n: 1 for n in TREE if n != "reanchor" or reanchor}
    want["session"] = 1
    want["program.separator_forward"] = batches
    assert {n: names.count(n) for n in set(names)} == want
    (session,) = [r for r in raw if r["name"] == "session"]
    assert session["parent"] is None
    assert session["attrs"] == {"audio_s": wav.shape[-1] / SR}
    for r in raw:
        assert r["session"] == session["id"]
        if r["name"] != "session":
            assert by_id[r["parent"]]["name"] == TREE[r["name"]]
            p = by_id[r["parent"]]
            assert p["start_ns"] <= r["start_ns"] <= r["end_ns"] \
                <= p["end_ns"]
    assert all(r["attrs"] == {"kind": "direct"} for r in raw
               if r["name"].startswith("program."))
    assert {k: v["count"] for k, v in rec["spans"].items()} == want
    assert rec["dropped"] == 0


def test_self_times_are_nonnegative_and_sum_to_the_session():
    pipe = _pipe()
    with trace.recording():
        pipe.process(_recording())
    rec = trace.collect()
    (session,) = [r for r in rec["raw"] if r["name"] == "session"]
    assert all(r["self_ns"] >= 0 for r in rec["raw"])
    assert sum(r["self_ns"] for r in rec["raw"]) == (
        session["end_ns"] - session["start_ns"])
    for name, agg in rec["spans"].items():
        mine = [r for r in rec["raw"] if r["name"] == name]
        assert agg["total_ns"] == sum(r["end_ns"] - r["start_ns"]
                                      for r in mine)
        assert agg["self_ns"] == sum(r["self_ns"] for r in mine)


@pytest.mark.parametrize("seconds", [1.5, 7.3, 12.0])
def test_counters_match_the_shapes(seconds):
    pipe = _pipe()
    wav = _recording(seconds)
    with trace.recording():
        outs = pipe.process(wav)
    c = trace.collect()["counters"]
    n = wav.shape[-1]
    win, hop = pipe.separator.win, pipe.separator.hop
    windows = max(1, -(-(n - win) // hop) + 1)
    assert c == {"sessions": 1, "audio_samples": n, "bytes_up": 4 * n,
                 "windows": windows,
                 "batch_slots": -(-windows // BATCH) * BATCH,
                 "bytes_down": 4 * n * pipe.num_spk}
    assert sum(o.nbytes for o in outs) == c["bytes_down"]


@pytest.mark.parametrize("name", COUNTERS)
def test_the_docstring_names_every_counter(name):
    assert f"``{name}``" in trace.__doc__


@pytest.mark.parametrize("blocks", [False, True], ids=["cpu", "host_blocks"])
def test_process_returns_the_same_float32_streams_through_host_blocks(
        blocks):
    """On the CPU the streams come back as they did, with no host block
    and none of its counters; through the pool (which a CUDA device
    takes) they are the same, and a dropped session's block is reused."""
    pipe = _pipe()
    assert pipe.host_blocks is None
    wav = _recording()
    plain = pipe.process(wav)
    if blocks:
        pipe.host_blocks = HostBlocks()
    with trace.recording():
        outs = pipe.process(wav)
        del outs
        outs = pipe.process(wav)
    c = trace.collect()["counters"]
    assert isinstance(outs, tuple) and len(outs) == len(plain) == 2
    for a, b in zip(outs, plain):
        assert a.dtype == np.float32 and np.array_equal(a, b)
    got = {k: v for k, v in c.items() if k.startswith("to_host_")}
    assert got == ({"to_host_pinned": 1, "to_host_reused": 1} if blocks
                   else {})


def test_streams_are_bit_equal_with_tracing_on_and_off():
    pipe = _pipe(reanchor=True)
    wav = _recording()
    off = pipe.process(wav)
    with trace.recording():
        on = pipe.process(wav)
    assert trace.collect()["spans"]
    assert len(on) == len(off)
    for a, b in zip(on, off):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_two_sessions_get_two_session_ids():
    pipe = _pipe()
    with trace.recording():
        pipe.process(_recording(3.0, seed=1))
        pipe.process(_recording(3.0, seed=2))
    raw = trace.collect()["raw"]
    sessions = [r["id"] for r in raw if r["name"] == "session"]
    assert len(sessions) == 2 and len(set(sessions)) == 2
    assert {r["session"] for r in raw} == set(sessions)
    for sid in sessions:  # each session's spans: one of each stage
        names = [r["name"] for r in raw if r["session"] == sid]
        assert names.count("upload") == names.count("to_host") == 1


def test_the_raw_span_cap_counts_what_it_dropped(monkeypatch):
    monkeypatch.setattr(trace, "MAX_SPANS", 3)
    with trace.recording():
        for _ in range(5):
            with trace.span("outer"):
                with trace.span("inner"):
                    pass
    rec = trace.collect()
    assert len(rec["raw"]) == 3 and rec["dropped"] == 7
    assert rec["spans"]["outer"]["count"] == 5
    assert rec["spans"]["inner"]["count"] == 5
    assert trace.collect()["raw"] == []  # collect() cleared the store


def test_on_enters_a_profiler_mark_per_span():
    pipe = _pipe()
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.recording():
            pipe.process(_recording(3.0))
    marks = [e.name() for e in prof.profiler.kineto_results.events()
             if e.name().startswith(trace.PREFIX)]
    spans = trace.collect()["spans"]
    assert sorted(set(marks)) == sorted(trace.PREFIX + n for n in spans)
    assert len(marks) == sum(a["count"] for a in spans.values())


def test_separate_cli_trace_adds_spans_and_counters(tmp_path, caplog):
    from css_tpu_torch.cli import separate
    from css_tpu_torch.data.wav_io import write_wav
    from css_tpu_torch.models import blstm
    from css_tpu_torch.trainer.checkpoint import save_checkpoint_dict

    conf = {"blstm_hdim": 16, "blstm_num_layers": 1}
    ckpt = tmp_path / "tiny.mdl"
    save_checkpoint_dict(str(ckpt), {"params": blstm.init_params(3, conf),
                                     "conf": conf})
    recs = tmp_path / "recs"
    recs.mkdir()
    for i in range(2):
        write_wav(recs / f"rec{i}.wav", _recording(3.0, seed=i))
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text("".join(
        f"{k}: {v}\n" if not isinstance(v, dict) else
        f"{k}:\n" + "".join(f"  {kk}: {vv}\n" for kk, vv in v.items())
        for k, v in CONFIG.items()))
    args = ["--config", str(cfg), "--checkpoint", str(ckpt), "--model",
            "BLSTM", "--corpus-dir", str(recs), "--device", "cpu"]

    def closing(extra):
        caplog.clear()
        with caplog.at_level(logging.INFO, logger="css_tpu_torch.separate"):
            separate.main(args + extra)
        line = [r.getMessage() for r in caplog.records
                if r.getMessage().startswith("kernel launches ")][-1]
        return json.loads(line[len("kernel launches "):])

    plain = closing(["--out-dir", str(tmp_path / "a")])
    assert set(plain) == {"launches", "plain_routes"}
    traced = closing(["--out-dir", str(tmp_path / "b"), "--trace"])
    assert not trace.enabled()
    assert traced["spans"]["session"]["count"] == 2
    assert traced["spans"]["to_host"]["count"] == 2
    for a in traced["spans"].values():
        assert 0 <= a["self_ms"] <= a["host_ms"]
    assert traced["counters"]["sessions"] == 2
    assert traced["counters"]["audio_samples"] == 2 * 3 * SR
    for i in range(2):  # the same streams either way
        for s in range(2):
            a = (tmp_path / "a" / f"rec{i}_{s}.wav").read_bytes()
            assert a == (tmp_path / "b" / f"rec{i}_{s}.wav").read_bytes()


@pytest.mark.parametrize("seven", [False, True], ids=["masking", "7ch"])
def test_the_mvdr_spans_come_with_souden_mvdr_alone(seven):
    pipe = _pipe_7ch() if seven else _pipe()
    wav = _recording_7ch() if seven else _recording()
    with trace.recording():
        pipe.process(wav)
    rec = trace.collect()
    raw = rec["raw"]
    by_id = {r["id"]: r for r in raw}
    names = [r["name"] for r in raw]
    if not seven:
        assert not [n for n in names if n.startswith("beamformer.")]
        return
    assert {n: names.count(n) for n in MVDR_TREE} == dict.fromkeys(
        MVDR_TREE, 1)
    for r in raw:
        if r["name"] in MVDR_TREE:
            p = by_id[r["parent"]]
            assert p["name"] == MVDR_TREE[r["name"]]
            assert p["start_ns"] <= r["start_ns"] <= r["end_ns"] \
                <= p["end_ns"]
    assert set(TREE) - {"reanchor"} <= set(names)


@pytest.mark.parametrize("seconds", [1.5, 7.3])
def test_7ch_counters_match_the_shapes(seconds):
    pipe = _pipe_7ch()
    wav = _recording_7ch(seconds)
    with trace.recording():
        pipe.process(wav)
    c = trace.collect()["counters"]
    n = wav.shape[-1]
    win, hop = pipe.separator.win, pipe.separator.hop
    windows = max(1, -(-(n - win) // hop) + 1)
    bins = pipe.separator.features.num_bins
    assert c["bytes_up"] == 4 * 7 * n and c["windows"] == windows
    assert c["merge_windows"] == windows
    assert c["mvdr_systems"] == windows * pipe.num_spk * bins
    assert c["merge_kills"] == int(pipe.separator.merge_kills)
    assert 0 <= c["merge_kills"] <= windows


def test_merge_kills_is_read_only_while_tracing():
    """The separator's device count of killed windows is read (a wait on
    the card) only under tracing, after the streams reached the host."""
    pipe = _pipe_7ch()
    separate, reads = pipe.separator.separate, []

    class Probe:
        def __init__(self, kills):
            self.kills = kills

        def __int__(self):
            reads.append(trace.enabled())
            return int(self.kills)

    def probed(wav):
        out = separate(wav)
        pipe.separator.merge_kills = Probe(pipe.separator.merge_kills)
        return out
    pipe.separator.separate = probed
    wav = _recording_7ch(3.0)
    pipe.process(wav)
    assert reads == []
    with trace.recording():
        pipe.process(wav)
    assert reads == [True]
    assert trace.collect()["counters"]["merge_kills"] == int(
        pipe.separator.merge_kills.kills)


def test_7ch_streams_are_bit_equal_with_tracing_on_and_off():
    pipe = _pipe_7ch()
    wav = _recording_7ch()
    off = pipe.process(wav)
    with trace.recording():
        on = pipe.process(wav)
    assert trace.collect()["spans"]["beamformer.mvdr"]["count"] == 1
    assert len(on) == len(off) == 2
    for a, b in zip(on, off):
        assert a.dtype == b.dtype and np.array_equal(a, b)
