"""7ch (spatial) training, device-mixed batches and the probe in
``cli.train``: the port against css_tpu on the CPU.

A small 7ch Conformer (2 blocks x 64, 4 heads, kernel 7, 1799 inputs: 257
magnitude bins and 6 IPD pairs) at dropout 0, MSE with noise weight 0.3,
float32; batches of 3 x 1 s from the port's ``SpatialMixer`` with sensor
noise 0.003.

Tolerances:
  * featurize: channel 0's and the sources' magnitudes 1e-5 absolute and
    relative (float32 STFTs summed in another order); the IPD
    wrap-aware through tests/test_torch_features.py's
    ``_assert_ipd_close``, which leaves out the entries whose centred
    phase vector is too short for the angle to be defined. The IPD is
    atan2 of the vector left when its mean over frames is taken off: where
    one source holds a bin through the window that vector is ~1e-7 long
    and two float32 STFTs can put its angle anywhere. On training windows
    a second ill-conditioning shows: a channel whose bin is near silent
    in a frame (magnitude ~5e-4 on this batch, where the two STFTs differ
    by ~1e-6) has a phase good to ~2e-3 rad only. Those entries are left
    out too: where the two STFTs' difference, over the magnitude, of the
    pair's two channels sums to more than IPD_ATOL / 2 (the pair's phase
    difference is then itself that far apart in the two packages);
  * one training step fed css_tpu's features: the loss 1e-5 relative,
    the gradients 1e-4 of their tensor's largest, or of 1e-3 where that
    is smaller (tests/test_torch_train_trainer.py's tolerances);
  * a step on a device-mixed batch against the same step on the host
    rendering of the same recipe (sensor noise 0): the loss 2e-4
    relative. The renderings differ by ~1e-6 (tests/test_torch_device_
    mixer.py), which the features' per-bin MVN amplifies on near-silent
    bins, as between the two packages' STFTs (tests/test_torch_train_
    trainer.py): 5.4e-5 relative on this batch;
  * the probe does not change training: the per-step losses and the
    checkpoints' params of two runs, with and without --probe-sessions,
    are equal bit for bit, on one CPU thread (with several, torch's CPU
    reductions vary from run to run by ~1e-9, and Adam's sign-like first
    steps carry that to ~1e-4 in the params of two runs without the
    probe).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from css_tpu.models import conformer as jc
from css_tpu.objectives.mse import MeanSquaredError as JMse
from css_tpu.ops import stft as jstft
from css_tpu.trainer import LRSchedule as JSchedule
from css_tpu.trainer import Trainer as JTrainer
from css_tpu_torch.cli import train as ttrain
from css_tpu_torch.data.corpus import SyntheticCorpus
from css_tpu_torch.data.device_mixer import DeviceMixer
from css_tpu_torch.data.mixer import MixtureSynthesizer
from css_tpu_torch.data.spatial import SpatialMixer
from css_tpu_torch.models import conformer as tc
from css_tpu_torch.models import to_jax
from css_tpu_torch.objectives.mse import MeanSquaredError
from css_tpu_torch.ops import stft as stft_ops
from css_tpu_torch.ops.features import parse_ipd_index
from css_tpu_torch.trainer import checkpoint as tckpt
from css_tpu_torch.trainer.loop import Trainer
from css_tpu_torch.trainer.lr_schedule import LRSchedule
from test_torch_features import IPD_ATOL, _assert_ipd_close, _centred_length

IPD = "1,0;2,0;3,0;4,0;5,0;6,0"
CONF = {"conformer_attention_dim": 64, "conformer_attention_heads": 4,
        "conformer_linear_units": 128, "conformer_num_blocks": 2,
        "conformer_kernel_size": 7, "conformer_dropout_rate": 0.0,
        "idim": 257 * 7}
TINY = ["--synthetic-data", "--synthetic-speakers", "4", "--synthetic-utts",
        "2", "--batch-size", "2", "--batches-per-epoch", "2",
        "--optim", "adam", "--lr", "1e-3", "--warmup", "2",
        "--conformer-num-blocks", "2", "--conformer-attention-dim", "64",
        "--conformer-linear-units", "128", "--conformer-kernel-size", "7",
        "--min-window-size", "1.0", "--max-window-size", "1.0",
        "--validate-batches", "1", "--keep-best", "--probe-session-sec",
        "4", "--probe-speakers", "4", "--probe-utts", "2", "--device", "cpu"]


def _mixer(seed, level=0.003):
    corpus = SyntheticCorpus(num_speakers=4, utts_per_speaker=2,
                             min_dur=2.0, max_dur=3.0, seed=seed)
    return SpatialMixer(MixtureSynthesizer(corpus, batch_size=3,
                                           min_window=1.0, max_window=1.0,
                                           seed=seed + 1),
                        noise_level=level, seed=seed + 2)


@pytest.fixture(scope="module")
def batch():
    return {k: v for k, v in next(_mixer(3)).items()
            if k not in ("ovl", "lens")}


@pytest.fixture(scope="module")
def pair(batch):
    jt = JTrainer(jc.Conformer.build_model(CONF), JMse(noise_weight=0.3),
                  JSchedule(lr=1e-3), optim="adam", weight_decay=1e-2,
                  grad_thresh=0.05, donate=False, ipd_index=IPD)
    state = jt.init_state(jax.random.PRNGKey(0), batch)
    tm = tc.Conformer.build_model(CONF)
    tm.load_state_dict(tc.params_from_jax(
        jax.tree.map(np.asarray, state.params),
        jax.tree.map(np.asarray, state.batch_stats)))
    tt = Trainer(tm, MeanSquaredError(noise_weight=0.3), LRSchedule(lr=1e-3),
                 optim="adam", weight_decay=1e-2, grad_thresh=0.05,
                 device="cpu", ipd_index=IPD)
    return jt, state, tt


def test_featurize_7ch_matches(batch, pair):
    jt, _, tt = pair
    want = jt._featurize(jax.tree.map(jnp.asarray, batch))
    got = tt.featurize(tt.to_device(batch))
    assert sorted(got) == sorted(want) == ["input", "source1", "source2"]
    for k in ("source1", "source2"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-5)
    g, w = got["input"].numpy(), np.asarray(want["input"])
    assert g.shape == w.shape and g.shape[-1] == 257 * 7
    np.testing.assert_allclose(g[..., :257], w[..., :257], rtol=1e-5,
                               atol=1e-5)
    b, t, _ = g.shape
    spec = np.asarray(jstft.stft(jnp.asarray(batch["mix"]), 512, 256))
    left, right = parse_ipd_index(IPD)
    length = _centred_length(np.angle(spec), left, right)  # (B, M, T, F)
    diff = np.abs(stft_ops.stft(torch.as_tensor(batch["mix"]), 512,
                                256).numpy() - spec)
    turn = diff / np.maximum(np.abs(spec), 1e-30)  # ~ each phase's error
    quiet = turn[:, left] + turn[:, right] > IPD_ATOL / 2
    assert quiet.mean() < 1e-3

    def ipd(x):
        return x[..., 257:].reshape(b, t, 6, 257).transpose(0, 2, 1, 3)

    _assert_ipd_close(ipd(g), ipd(w), np.where(quiet, 0.0, length))


def test_7ch_step_fed_reference_features(batch, pair):
    jt, state, tt = pair
    feats = jt._featurize(jax.tree.map(jnp.asarray, batch))
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        jt._loss_fn, has_aux=True), static_argnums=(4,))(
        state.params, state.batch_stats, feats, jax.random.PRNGKey(0), True)
    tfeats = {k: torch.as_tensor(np.array(v)) for k, v in feats.items()}
    tt.model.train()
    tt.model.zero_grad()
    loss, _ = tt.objective(tt.model(tfeats["input"]), tfeats)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    got = to_jax({n: p.grad for n, p in tt.model.named_parameters()})[0]
    for g, w in zip(tckpt.tree_leaves(got), jax.tree.leaves(jgrads)):
        w = np.asarray(w, np.float64)
        scale = max(float(np.abs(w).max()), 1e-3)
        assert np.abs(g - w).max() <= 1e-4 * scale


def test_multichannel_batches_need_ipd_index(batch):
    tt = Trainer(tc.Conformer.build_model(CONF), MeanSquaredError(),
                 LRSchedule(lr=1e-3), device="cpu")
    with pytest.raises(ValueError, match="ipd_index"):
        tt.featurize(tt.to_device(batch))


def test_device_mixed_step_equals_host_mixed(pair):
    _, _, tt = pair
    mixer = _mixer(5, level=0.0)
    dmix = DeviceMixer(mixer, device="cpu")
    recipe = mixer.mixer.sample_recipe()
    enc = dmix.encode(recipe)
    host = mixer.spatialize_batch(mixer.mixer.materialize_recipe_host(recipe),
                                  az=np.rad2deg(enc["dm_f"][:, 3:5]))
    state = tt.state()
    loss_d, _, _ = tt.compute_grads(enc, dmix)
    tt.load_state(state)
    loss_h, _, _ = tt.compute_grads({k: v for k, v in host.items()
                                     if k not in ("ovl", "lens")})
    np.testing.assert_allclose(float(loss_d.detach()),
                               float(loss_h.detach()), rtol=2e-4)


def _records(expdir):
    with open(expdir / "train.1.jsonl") as fh:
        return [json.loads(line) for line in fh]


def test_cli_spatial_device_mix_probe_end_to_end(tmp_path):
    expdir = tmp_path / "exp"
    trainer = ttrain.main(TINY + [
        "--expdir", str(expdir), "--num-epochs", "3", "--num-workers", "2",
        "--spatialize-channels", "7", "--device-mix",
        "--probe-sessions", "1", "--average-probe-top", "2"])
    assert trainer.ipd_pairs is not None
    names = sorted(p.name for p in expdir.iterdir())
    assert names == ["2.1.mdl", "3.1.mdl", "avgtop.1.mdl", "best.1.mdl",
                     "conf.1.json", "train.1.jsonl"]
    records = _records(expdir)
    probes = [r["probe_si_snri_db"] for r in records
              if "probe_si_snri_db" in r]
    assert len(probes) == 3 and np.isfinite(probes).all()
    # the average of the two best-probed epochs, or the best epoch alone
    # where the average probes worse
    final = records[-1]
    assert final["avgtop_probe_si_snri_db"] >= max(probes)
    assert (len(final["avgtop_epochs"]) == 2
            or final["avgtop_epochs"] == [int(np.argmax(probes)) + 1])
    avg = tckpt.load_checkpoint(expdir / "avgtop.1.mdl")
    assert avg["params"]["conformer"]["embed_linear"]["kernel"].shape == (
        1799, 64)
    best = tckpt.load_checkpoint(expdir / "best.1.mdl")
    assert best["probe_si_snri_db"] == max(probes)


def test_probe_does_not_change_training(tmp_path):
    runs = []
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for probe in ([], ["--probe-sessions", "1"]):
            expdir = tmp_path / f"run{len(runs)}"
            ttrain.main(TINY + ["--expdir", str(expdir), "--num-epochs", "2",
                                "--num-workers", "1",
                                "--conformer-dropout-rate", "0.1"] + probe)
            runs.append(expdir)
    finally:
        torch.set_num_threads(threads)
    losses = [[r["loss"] for r in _records(e) if "loss" in r] for e in runs]
    assert len(losses[0]) == 2 and losses[0] == losses[1]
    a, b = (tckpt.load_checkpoint(e / "2.1.mdl") for e in runs)
    for x, y in zip(tckpt.tree_leaves(a["params"]),
                    tckpt.tree_leaves(b["params"])):
        np.testing.assert_array_equal(x, y)
