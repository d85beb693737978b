"""The port's 7-channel path against the benchmark's plain reference
(``bench_gpu/reference/separation_7ch.py``) on the CPU: the benchmark's
7-mic cell cut to a CPU's size (``TINY`` of the separation driver: one
Conformer block of the published width), its seeded random weights on
both sides, and sessions of the cell's array made by
``bench_gpu/harness/sessions.py``.

The program runs in float32, as the cell does, so every stage is held to
float32's own agreement: the spectra bit for bit (see the reference on
the IPD's branch cuts), the MVN'd magnitudes to 1e-4, the IPD angles to
1e-3, the DOA merge's decisions and DOAs exactly, the MVDR streams to
1e-4 (their Souden stage in float64 on both sides: the noise SCMs'
condition numbers reach 1e6-1e8, where float32 decides ~1e-2). End to
end the streams are compared as the cell's check compares them
(``drivers/separation.py:errors``), under its limit. Then planted
faults (the noise SCM replaced by the identity, an IPD pair dropped, the
DOA merge turned off, the Souden stage in complex64) each fail the cell's
check."""

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

from bench_gpu.drivers import separation as drv  # noqa: E402
from bench_gpu.harness import manifest, sessions  # noqa: E402
from bench_gpu.harness.setup import (program_model, reference,  # noqa: E402
                                     weights_for)
from bench_gpu.harness.trace import Tracer  # noqa: E402
from bench_gpu.reference import separation as r1  # noqa: E402
from bench_gpu.reference import separation_7ch as r7  # noqa: E402
from css_tpu_torch.executor import beamformer as bf_mod  # noqa: E402
from css_tpu_torch.executor.doa import (SteeringVectors,  # noqa: E402
                                        steervec_7ch)
from css_tpu_torch.executor.pipeline import CssPipeline  # noqa: E402
from css_tpu_torch.executor.windowing import pad_for_windows  # noqa: E402

CELL = "conformer_css7ch.sep_libricss7ch10min"
SEED = 2 ** 31 + 2027
CPU = torch.device("cpu")
FEATURE_ATOL = 1e-4
IPD_ATOL = 1e-3
MVDR_ATOL = 1e-4


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
    """(configuration, traffic) of the cell at the driver's CPU size."""
    cell = manifest.load_cell(CELL)
    assert cell.config["dtype"] == "float32"
    assert not cell.config["program_conf"]["bf16"]
    return (_merged(cell.config, drv.TINY["config"]),
            _merged(cell.traffic, drv.TINY["traffic"]))


@pytest.fixture(scope="module")
def setup(cut):
    cfg, traffic = cut
    wav = sessions.session(traffic["session"], SEED, 0, CPU)
    pipe = CssPipeline(program_model(cfg, SEED, CPU), cfg["pipeline"],
                       device=CPU)
    ref, p = reference(cfg), weights_for(cfg, SEED, CPU)

    def masks(feats):
        return ref.masks(p, feats, cfg["widths"])
    return cfg, wav, pipe, masks


def _windows(wav, g):
    return r1.windows(wav, g["win"], g["hop"]).transpose(0, 1).contiguous()


def test_the_cells_files_import_no_program_and_no_jax():
    """The reference, the cost file and the readers the cell brings, in a
    fresh process: nothing of ``css_tpu``, ``css_tpu_torch`` or JAX."""
    import json
    import subprocess

    probe = (
        "import json, sys\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "from bench_gpu.harness import manifest\n"
        "import bench_gpu.reference.separation_7ch\n"
        "manifest.cost('conformer_css7ch')\n"
        "for m in ('mvdr_dev_ms', 'scm_dev_ms', 'mvdr_solve_dev_ms'):\n"
        "    manifest.reader(m + '.sep7')\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                         text=True, check=True, timeout=300)
    mods = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "torch" in mods
    assert not mods & {"jax", "jaxlib", "flax", "css_tpu", "css_tpu_torch"}


def test_session_is_the_cells_array(cut):
    cfg, traffic = cut
    wav = sessions.session(traffic["session"], SEED, 0, CPU)
    assert wav.shape == (7, 5 * 16000)
    assert cfg["widths"]["idim"] == 257 * 7


def test_ipd_features_equal_the_references(setup):
    cfg, wav, pipe, _ = setup
    g = r1.geometry(cfg["pipeline"])
    wins = _windows(wav, g)
    assert wins.shape[0] <= cfg["pipeline"]["separation"]["batch_size"]
    spec, mag, feats = r7.features(
        wins, r7.ipd_pairs(cfg["pipeline"]["separation"]["ipd"]), g)
    got_mag, got, got_spec = pipe.separator.features(wins, return_spec=True)
    assert got.shape == feats.shape == (wins.shape[0], 150, 7 * 257)
    # the conv-STFT's one product from the definition's matrix, in the
    # pipeline's batches: the spectra round alike, so do the IPD's cuts
    assert torch.equal(got_spec, spec)
    assert (got_mag - mag).abs().max() <= 1e-6 * spec.abs().amax()
    np.testing.assert_allclose(got[..., :257], feats[..., :257],
                               atol=FEATURE_ATOL)
    d = got[..., 257:] - feats[..., 257:]
    assert d.abs().max() <= IPD_ATOL


def _oracle(traffic, g):
    """The cell's two talkers apart on the array (no noise), their
    mixture with the traffic's noise, and per window the binary masks of
    the louder talker in channel 0 (B, T, F, 3)."""
    p = dict(traffic["session"], noise=0.0)
    srcs = [sessions.session(dict(p, voices=[v], azimuths=[az]), SEED, 0,
                             CPU)
            for v, az in zip(p["voices"], p["azimuths"])]
    noise = torch.randn(srcs[0].shape,
                        generator=torch.Generator().manual_seed(SEED))
    mix = srcs[0] + srcs[1] + traffic["session"]["noise"] * noise
    mags = [r7.features(_windows(s, g), [], g)[1] for s in srcs]
    first = (mags[0] > mags[1]).float()
    masks = torch.stack([first, 1.0 - first, torch.zeros_like(first)], -1)
    return mix, masks


def test_steering_vectors_are_the_references():
    sv, angles = steervec_7ch()
    ref_sv, ref_angles = r7.steering(257, 16000, CPU)
    np.testing.assert_allclose(sv, ref_sv.numpy(), atol=1e-6)
    np.testing.assert_allclose(angles, ref_angles.numpy(), atol=1e-4)


def test_oracle_masks_find_the_traffics_azimuths(cut):
    """Masks of the true talkers give DOAs within one grid step (12
    degrees) of the azimuths the cell's traffic places them at, on the
    program's steering vectors and the reference's: the cell's ``mics``
    and the program describe one array."""
    cfg, traffic = cut
    g = r1.geometry(cfg["pipeline"])
    mix, masks = _oracle(traffic, g)
    spec, _, _ = r7.features(_windows(mix, g), [], g)
    want = torch.tensor(traffic["session"]["azimuths"])
    _, got = SteeringVectors().merge_decisions(spec, masks[..., :2])
    _, ref = r7.merge(spec, masks, cfg["pipeline"])
    for doa in (got, ref):
        gap = torch.remainder(doa - want, 360.0)
        assert torch.minimum(gap, 360.0 - gap).max() < 12.0, doa


def test_doa_merge_makes_the_same_kills(setup, cut):
    """The same spectra and masks through both merges: the model's masks
    (random weights, whose two streams mostly point one way: kills) and
    the talkers' own (apart: none)."""
    cfg, wav, pipe, masks_fn = setup
    g = r1.geometry(cfg["pipeline"])
    wins = _windows(wav, g)
    spec, _, feats = r7.features(
        wins, r7.ipd_pairs(cfg["pipeline"]["separation"]["ipd"]), g)
    model = torch.clamp(masks_fn(feats), max=1.0)
    mix, oracle = _oracle(cut[1], g)
    spec = torch.cat([spec, r7.features(_windows(mix, g), [], g)[0]])
    masks = torch.cat([model, oracle])
    kill, doa = SteeringVectors().merge_decisions(
        spec, masks[..., :2],
        thresh=cfg["pipeline"]["separation"]["merge_threshold"])
    ref_kill, ref_doa = r7.merge(spec, masks, cfg["pipeline"])
    assert torch.equal(kill, ref_kill) and torch.equal(doa, ref_doa)
    assert kill.any() and not kill[-oracle.shape[0]:].any()


def test_mvdr_streams_match(setup):
    """Souden MVDR from the same stitched masks: the program's beamformer
    and the reference's, each with its Souden stage in float64 and its
    spectra in float32 (measured ~1e-5 apart on the 0.9-peak streams)."""
    cfg, wav, pipe, _ = setup
    g = r1.geometry(cfg["pipeline"])
    padded = pad_for_windows(wav, pipe.separator.win, pipe.separator.hop)
    masks, mags = pipe.separator.separate(padded)
    stitched = pipe.stitcher(masks, mags)
    got = pipe.beamformer.continuous_process(padded, stitched)
    st = torch.stack(stitched, -1).permute(2, 0, 1).unfold(
        1, g["mask_win"], g["hop_frames"]).permute(1, 0, 3, 2)
    wavs = r7.mvdr(_windows(wav, g), st[:, :2], st[:, 2], g)
    for s, y in enumerate(got):
        want = r7.assemble(wavs[:, s], padded.shape[-1], g)
        assert y.shape == want.shape
        assert (y - want).abs().max() <= MVDR_ATOL
        assert (y - want).norm() <= MVDR_ATOL * want.norm()


def test_pipeline_matches_the_reference(setup, cut):
    """``CssPipeline.process`` against ``separation_7ch.separate`` on a
    20 s session (22 windows: see the fault test below), as the cell's
    check compares them and under its limit."""
    cfg, _, pipe, masks_fn = setup
    wav = sessions.session(dict(cut[1]["session"], seconds=20), SEED, 1,
                           CPU)
    outs = pipe.process(wav.numpy())
    refs = r7.separate(wav, masks_fn, cfg["pipeline"], 2)
    err = drv.errors(outs, refs, cfg["pipeline"]["separation"]
                     ["frame_length"])
    limit = cfg["limits"]["separation"]["frame_p50"]
    assert err["frame_p50"] <= limit, err
    assert err["gain_gap"] <= limit, err


# planted faults: each must fail the cell's check


def _identity_noise_scm(pipe, monkeypatch):
    compute_scm = bf_mod.compute_scm

    def scm(spec, mask, loading):
        out = compute_scm(spec, mask, loading)
        if mask.shape[-3] == 1:  # the noise stream's
            out = torch.eye(out.shape[-1], dtype=out.dtype).expand_as(out)
        return out
    monkeypatch.setattr(bf_mod, "compute_scm", scm)


class _PairDropped:
    """The separator's features with the last IPD pair's bins zeroed."""

    def __init__(self, inner):
        self._inner = inner

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def __call__(self, x, return_spec=False):
        out = self._inner(x, return_spec=return_spec)
        feats = out[1].clone()
        feats[..., -self._inner.num_bins:] = 0.0
        return (out[0], feats) + tuple(out[2:])


def _pair_dropped(pipe, monkeypatch):
    pipe.separator.features = _PairDropped(pipe.separator.features)


def _merge_off(pipe, monkeypatch):
    pipe.separator.merge = False


def _souden_in_complex64(pipe, monkeypatch):
    """The SCMs and the solves in complex64, as a float32 program runs
    them (the cell states float64 for that stage)."""
    compute_scm, souden = bf_mod.compute_scm, bf_mod.souden_coefficients

    def scm(spec, mask, loading):
        return compute_scm(spec.to(torch.complex64), mask.float(),
                           loading).to(spec.dtype)

    def coefficients(noise_scm, tgt_scm):
        return souden(noise_scm.to(torch.complex64),
                      tgt_scm.to(torch.complex64)).to(noise_scm.dtype)
    monkeypatch.setattr(bf_mod, "compute_scm", scm)
    monkeypatch.setattr(bf_mod, "souden_coefficients", coefficients)


FAULTS = {"none": None, "identity_noise_scm": _identity_noise_scm,
          "ipd_pair_dropped": _pair_dropped, "merge_off": _merge_off,
          "souden_in_complex64": _souden_in_complex64}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_planted_fault_fails_the_cells_check(fault, cut, monkeypatch):
    """The cell at its driver's CPU size, through the driver and under
    the cell's limits: a run with the timed path broken underneath is not
    correct, and the unbroken one is. The check's median frame is the
    session's: in the driver's 5 s sessions (5 windows) one window whose
    IPD or merge decision float32 leaves undecided is a fifth of the
    frames, so these sessions are 20 s (22 windows; the cell's have
    748)."""
    cell = manifest.load_cell(CELL)
    cell.config, cell.traffic = copy.deepcopy(cut)
    cell.traffic["session"]["seconds"] = 20
    hooks = {}
    if FAULTS[fault] is not None:
        hooks["pipeline"] = lambda pipe: FAULTS[fault](pipe, monkeypatch)
    out = manifest.driver(cell).run(
        cell, seed=SEED + 1, seconds=0.5, device=CPU,
        tracer=Tracer(False, CPU), t0=time.perf_counter(), hooks=hooks)
    assert out.correct is (fault == "none"), out.checks
