"""The port's time-domain path against the benchmark's plain reference
(``bench_gpu/reference/conv_tasnet.py`` inside ``separation_wave.py``) on
the CPU: the Conv-TasNet cell cut to a CPU's size (``TINY`` of the
``separation_wave`` driver), its seeded random weights on both sides, and
sessions of the cell's traffic made by ``bench_gpu/harness/sessions.py``.

The program runs in float32 here, so the model's streams are held to
float32's agreement, the boundary permutations exactly, and the
pipeline's streams by the cell's own check (``drivers/separation.py:
errors`` under the configuration's limits). Then planted faults each fail
that check: in the model (the PReLU slopes dropped, gLN computed as cLN,
every dilation 1) against the reference, and in the stitcher (the
boundary permutations ignored, the shared samples taken 256 out of line)
on windows cut from two known sources and swapped from window 1 on."""

import copy
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench_gpu.harness import manifest, sessions  # noqa: E402
from bench_gpu.harness.setup import (program_model, reference,  # noqa: E402
                                     weights_for)
from bench_gpu.harness.trace import Tracer  # noqa: E402
from bench_gpu.reference import separation_wave as rw  # noqa: E402
from css_tpu_torch.executor.pipeline import CssPipeline  # noqa: E402
from css_tpu_torch.executor.windowing import pad_for_windows  # noqa: E402
from css_tpu_torch.models import conv_tasnet  # noqa: E402
from css_tpu_torch.utils import trace  # noqa: E402

CELL = "conv_tasnet_css512x24.sep_libricss10min_wave"
DRIVER = manifest.driver_module("separation_wave")
SEED = 2 ** 31 + 2029
CPU = torch.device("cpu")


def _merged(base, over):
    """``over`` merged into ``base``, as ``bench_gpu/run.py`` merges a
    test's overrides (run.py itself sets environment variables when
    imported)."""
    out = dict(base)
    for k, v in over.items():
        out[k] = (_merged(out[k], v) if isinstance(v, dict)
                  and isinstance(out.get(k), dict) else v)
    return out


@pytest.fixture(scope="module")
def cut():
    """(configuration, traffic) of the cell at the driver's CPU size, the
    program in float32."""
    cell = manifest.load_cell(CELL)
    assert cell.config["dtype"] == "bfloat16"
    cfg = _merged(cell.config, DRIVER.TINY["config"])
    assert not cfg["program_conf"]["bf16"]
    return cfg, _merged(cell.traffic, DRIVER.TINY["traffic"])


@pytest.fixture(scope="module")
def setup(cut):
    cfg, traffic = cut
    wav = sessions.session(traffic["session"], SEED, 0, CPU)
    pipe = CssPipeline(program_model(cfg, SEED, CPU), cfg["pipeline"],
                       device=CPU)
    ref, p = reference(cfg), weights_for(cfg, SEED, CPU)

    def wave_fn(wins):
        return ref.streams(p, wins, cfg["widths"])
    return cfg, wav, pipe, wave_fn


def _limits(cfg):
    return cfg["limits"]["separation_wave"]


def _passes(err, cfg):
    return all(err[k] <= v for k, v in _limits(cfg).items())


def test_the_cells_files_import_no_program_and_no_jax():
    """The references, the driver, the cost file and the reader the cell
    brings, in a fresh process: nothing of ``css_tpu``, ``css_tpu_torch``
    or JAX."""
    import json
    import subprocess

    probe = (
        "import json, sys\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "from bench_gpu.harness import manifest\n"
        "import bench_gpu.reference.conv_tasnet\n"
        "import bench_gpu.reference.separation_wave\n"
        "manifest.driver_module('separation_wave')\n"
        "manifest.cost('conv_tasnet_css512x24')\n"
        "manifest.reader('wave_stitch_dev_ms.sepw')\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                         text=True, check=True, timeout=300)
    mods = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "torch" in mods
    assert not mods & {"jax", "jaxlib", "flax", "css_tpu", "css_tpu_torch"}


def test_the_cost_file_counts_a_window_by_hand():
    """33.60 GFLOP a 2.4 s window at the cell's widths: 4,831 encoder
    frames; a frame's encoder 2 L N, bottleneck 2 N B, 24 blocks of 2 B H
    twice and 2 H P, the mask head 2 B 3N and the decoder 2 3N L."""
    cfg = manifest.load_cell(CELL).config
    cost = manifest.cost("conv_tasnet_css512x24")
    frames = (38656 - 16) // 8 + 1
    assert frames == 4831
    frame = (2 * 16 * 512 + 2 * 512 * 128 + 24 * (4 * 128 * 512 + 2 * 512 * 3)
             + 2 * 128 * 1536 + 2 * 1536 * 16)
    assert cost.forward_flops(cfg["widths"], 1, frames) == frames * frame
    assert cost.forward_flops(cfg["widths"], 1, frames) / 1e9 == \
        pytest.approx(33.60, abs=0.005)


@pytest.mark.parametrize("norm", ["gln", "cln"])
def test_forward_matches_the_reference(norm, cut):
    cfg, traffic = cut
    cfg = _merged(cfg, {"widths": {"norm": norm},
                        "program_conf": {"conv_tasnet_norm": norm}})
    model = program_model(cfg, SEED, CPU)
    wins = sessions.session(traffic["session"], SEED, 1, CPU)[:2 * 38656]
    wins = wins.reshape(2, 38656)
    with torch.no_grad():
        got = model(wins)
    want = reference(cfg).streams(weights_for(cfg, SEED, CPU), wins,
                                  cfg["widths"])
    assert got.shape == want.shape == (2, 2, 38656)
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


def test_seeded_weights_give_live_streams_at_the_cells_depth(cut):
    """24 blocks (the cell's 3 x 8, dilations to 128) of seeded weights, at
    small widths: finite streams, neither silent nor one the other's copy,
    and each block's output not the eps of a norm."""
    cfg, traffic = cut
    widths = _merged(cfg["widths"], {"num_blocks": 8, "num_layers": 3})
    spec = reference(cfg).spec(widths)
    from bench_gpu.harness import weights

    p = weights.make(spec, SEED, CPU)
    wins = sessions.session(traffic["session"], SEED, 2, CPU)[:38656][None]
    out = reference(cfg).streams(p, wins, widths)[0]
    assert torch.isfinite(out).all()
    std = out.std(dim=-1)
    assert (std > 1e-3 * wins.std()).all(), std
    corr = torch.corrcoef(out)[0, 1]
    assert corr.abs() < 0.9, corr


def test_wave_stitcher_matches_the_reference_and_routes_a_planted_swap(
        setup):
    """The separator's windows, their streams swapped from window 2 on:
    the program's boundary permutations equal the reference's, swap at
    boundary 1 alone, and route the windows back to the unplanted order,
    counted once in ``stitch_swaps``."""
    cfg, wav, pipe, _ = setup
    padded = pad_for_windows(wav, pipe.separator.win, pipe.separator.hop)
    streams, none = pipe.separator.separate(padded)
    assert none is None and streams.shape[1:] == (2, pipe.separator.win)
    assert streams.shape[0] >= 4
    planted = streams.clone()
    planted[2:] = planted[2:].flip(1)
    g = rw.geometry(cfg["pipeline"])
    want = rw.boundary_perms(planted, g["hop"], 2)
    got = pipe.stitcher.wave_perms(planted)
    assert torch.equal(got, want)
    swapped = (got != torch.arange(2)).any(-1)
    assert swapped.tolist() == [i == 1 for i in range(len(got))]
    with trace.recording():
        routed = pipe.stitcher.waves(planted)
    rec = trace.collect()
    assert rec["counters"]["stitch_swaps"] == 1
    assert {"stitcher", "stitcher.wave", "stitcher.scan"} <= set(rec["spans"])
    assert torch.equal(routed, streams)


def test_pipeline_matches_the_reference(setup):
    """``CssPipeline.process`` against ``separation_wave.separate`` on the
    cell's session, as the cell's check compares them and under its
    limits; and the proceed-margin assembly sample for sample."""
    cfg, wav, pipe, wave_fn = setup
    outs = pipe.process(wav.numpy())
    refs = rw.separate(wav, wave_fn, cfg["pipeline"], 2)
    err = DRIVER.SEP.errors(outs, refs, cfg["pipeline"]["separation"]
                            ["frame_length"])
    assert _passes(err, cfg), err
    assert err["stream_err"] < 1e-5, err
    for y, r in zip(outs, refs):
        assert y.shape == r.shape == wav.shape
        assert np.abs(y).max() == pytest.approx(0.9)


# planted faults: each must fail the cell's check


def _prelu_dropped(pipe, monkeypatch):
    """Every PReLU a ReLU: the drawn slopes dropped."""
    monkeypatch.setattr(conv_tasnet, "prelu", lambda x, a: torch.relu(x))


def _gln_as_cln(pipe, monkeypatch):
    """gLN's statistics over each frame's channels, not the window's."""
    def cln(x, scale, bias, eps=1e-5):
        mean = x.mean(dim=-1, keepdim=True)
        var = torch.square(x - mean).mean(dim=-1, keepdim=True)
        return scale * (x - mean) / torch.sqrt(var + eps) + bias
    monkeypatch.setattr(conv_tasnet, "global_layer_norm", cln)


def _dilation_one(pipe, monkeypatch):
    for name in pipe.model.blocks:
        getattr(pipe.model, name).dilation = 1


MODEL_FAULTS = {"none": None, "prelu_dropped": _prelu_dropped,
                "gln_as_cln": _gln_as_cln, "dilation_one": _dilation_one}


@pytest.mark.parametrize("fault", sorted(MODEL_FAULTS))
def test_a_planted_model_fault_fails_the_cells_check(fault, cut,
                                                     monkeypatch):
    """The cell at its driver's CPU size, through the driver and under
    the cell's limits: a run with the model broken underneath is not
    correct, and the unbroken one is."""
    cell = manifest.load_cell(CELL)
    cell.config, cell.traffic = copy.deepcopy(cut)
    hooks = {}
    if MODEL_FAULTS[fault] is not None:
        hooks["pipeline"] = lambda pipe: MODEL_FAULTS[fault](pipe,
                                                             monkeypatch)
    out = DRIVER.run(cell, seed=SEED + 1, seconds=0.1, device=CPU,
                     tracer=Tracer(False, CPU), t0=time.perf_counter(),
                     hooks=hooks)
    assert out.correct is (fault == "none"), out.checks


def _perms_ignored(stitcher):
    stitcher.wave_perms = lambda s: torch.arange(
        s.shape[1]).expand(s.shape[0] - 1, s.shape[1])


def _misaligned_margin(stitcher):
    """The shared samples taken as (eval_win - eval_hop) * sr = 25,600,
    the last of window b against the first of window b+1: 256 samples out
    of line."""
    stitcher.overlap = 25600


STITCH_FAULTS = {"none": None, "perms_ignored": _perms_ignored,
                 "misaligned_margin": _misaligned_margin}


@pytest.mark.parametrize("fault", sorted(STITCH_FAULTS))
def test_a_planted_stitching_fault_fails_the_cells_check(fault, cut):
    """Windows cut from two known sources (white noise a stream, each
    window of a stream the source's own samples), swapped from window 1
    on, in the separator's place: the pipeline gives the two sources back
    by the cell's check and limits, and a stitcher that ignores the
    boundary permutations, or compares the windows 256 samples out of
    line, does not."""
    cfg, _ = cut
    pipe = CssPipeline(program_model(cfg, SEED, CPU), cfg["pipeline"],
                       device=CPU)
    sep = pipe.separator
    gen = torch.Generator().manual_seed(SEED)
    total = 30 * 16000
    sources = 0.1 * torch.randn(2, total, generator=gen)
    padded = pad_for_windows(sources, sep.win, sep.hop)

    def separate(wav):
        wins = padded.unfold(-1, sep.win, sep.hop).transpose(0, 1).clone()
        wins[1:] = wins[1:].flip(1)
        return wins, None
    sep.separate = separate
    if STITCH_FAULTS[fault] is not None:
        STITCH_FAULTS[fault](pipe.stitcher)
    outs = pipe.process(np.zeros(total, np.float32))
    refs = tuple(s * 0.9 / s[:total].abs().max() for s in padded)
    err = DRIVER.SEP.errors(outs, tuple(r[:total] for r in refs),
                            cfg["pipeline"]["separation"]["frame_length"])
    assert _passes(err, cfg) is (fault == "none"), err
