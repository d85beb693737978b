"""The port's Trainer against css_tpu's on the same weights and batches.

Small Conformer (2 blocks x 64, 4 heads, kernel 7) at dropout 0, MSE with
noise weight 0.3, float32 on the CPU (css_tpu pins float32 matmuls to full
precision), batches from the port's mixer with a numpy seed. One and three
steps of Adam with weight decay 1e-2 and a clip that binds (grad_thresh
below the gradient norm), and of SGD, against
``css_tpu.trainer.Trainer._train_step_impl``.

The step is fed css_tpu's features (``Trainer._featurize``): the two
packages' float32 STFT magnitudes differ by ~5e-6 absolute (summation
order; held separately below), and the model's per-bin MVN amplifies that
on the near-silent bins of the synthetic corpus (its noise is an 8-tap
moving average, with zeros at multiples of 2 kHz): fed their own features,
the gradients differ by up to ~1e-2 of a tensor's largest, in either
package's float32.

Tolerances. Features: 1e-5 absolute and relative. Loss: 1e-5 relative
(float32 sums in another order). Gradient norm: 1e-4 relative. Gradients:
1e-4 of their tensor's largest magnitude, or of 1e-3 where that is
smaller (the k bias and the biases ahead of BatchNorm have a gradient of 0
in exact arithmetic, ~1e-8 of float32 rounding in both). BatchNorm statistics: 1e-6 absolute. SGD's params: 1e-6
absolute (the update is lr * g, lr <= 1e-2, on params of order 1).
Adam's mu and nu: 1e-4 of their tensor's largest magnitude, or of 1e-3 of
the largest over all tensors where that is smaller (the zero gradients
above). Adam's params
where |g| exceeds 1e-3 of its tensor's largest (with the floor above):
1e-6 absolute (there
Adam's first update is close to lr * sign(g) and the two packages agree;
where g is near 0, a 1e-6 change of g can move the update by up to 2 lr,
so those elements are not compared). Step counters and Adam's counts:
equal. After Adam steps, the BatchNorm means also get 0.2 times the sum of
the rates applied so far: the depthwise conv's bias has a zero gradient
(BatchNorm removes it from the output) but moves the batch mean, and Adam
moves it by about lr * sign(rounding noise) a step, independently in the
two packages, which the running mean takes at 0.1 a step. For the same reason the
three-step Adam test leaves out the moments of the parameters whose
gradient vanishes (below 1e-6 of the largest): their mu and nu carry
weight decay times that walk.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from css_tpu.models import conformer as jc
from css_tpu.objectives.mse import MeanSquaredError as JMse
from css_tpu.trainer import LRSchedule as JSchedule
from css_tpu.trainer import Trainer as JTrainer
from css_tpu_torch.data.corpus import SyntheticCorpus
from css_tpu_torch.data.mixer import MixtureSynthesizer
from css_tpu_torch.models import conformer as tc
from css_tpu_torch.models import to_jax
from css_tpu_torch.objectives.mse import MeanSquaredError
from css_tpu_torch.trainer.checkpoint import tree_leaves
from css_tpu_torch.trainer.lr_schedule import LRSchedule
from css_tpu_torch.trainer.loop import Trainer

CONF = {"conformer_attention_dim": 64, "conformer_attention_heads": 4,
        "conformer_linear_units": 128, "conformer_num_blocks": 2,
        "conformer_kernel_size": 7, "conformer_dropout_rate": 0.0}
CLIP = 0.05


@pytest.fixture(scope="module")
def batches():
    corpus = SyntheticCorpus(num_speakers=4, utts_per_speaker=2,
                             min_dur=2.0, max_dur=3.0, seed=3)
    ds = MixtureSynthesizer(corpus, batch_size=3, min_window=1.0,
                            max_window=1.0, seed=4)
    return [{k: v for k, v in next(ds).items() if k not in ("ovl", "lens")}
            for _ in range(3)]


_JAX_TRAINERS = {}


def _jax_trainer(optim, wd, sched):
    """css_tpu's Trainer, one per configuration (its steps compile once)."""
    key = (optim, wd, tuple(sorted(sched.items())))
    if key not in _JAX_TRAINERS:
        _JAX_TRAINERS[key] = JTrainer(
            jc.Conformer.build_model(CONF), JMse(noise_weight=0.3),
            JSchedule(**sched), optim=optim, weight_decay=wd,
            grad_thresh=CLIP, donate=False)
    return _JAX_TRAINERS[key]


def _pair(optim, batch, wd=1e-2, sched=None):
    """(css_tpu trainer, its state, the port's trainer) on one weights."""
    sched = sched or dict(lr=1e-3)
    jt = _jax_trainer(optim, wd, sched)
    state = jt.init_state(jax.random.PRNGKey(0), batch)
    rng = np.random.default_rng(1)
    stats = jax.tree.map(lambda a: np.asarray(a) + rng.uniform(
        0.1, 0.3, np.shape(a)).astype(np.float32), state.batch_stats)
    state = state.replace(batch_stats=jax.tree.map(jnp.asarray, stats))
    tm = tc.Conformer.build_model(CONF)
    tm.load_state_dict(tc.params_from_jax(
        jax.tree.map(np.asarray, state.params), stats))
    tt = Trainer(tm, MeanSquaredError(noise_weight=0.3),
                 LRSchedule(**sched), optim=optim, weight_decay=wd,
                 grad_thresh=CLIP, device="cpu")
    return jt, state, tt


def _close_rel_max(got, want, rel, where=None, floor=1e-30):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), floor)
    diff = np.abs(got - want)
    if where is not None:
        diff = diff[where]
    assert diff.max(initial=0.0) <= rel * scale, (diff.max(), scale)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _grad_fn(jt):
    """Jitted value_and_grad of css_tpu's loss, one per trainer."""
    if not hasattr(jt, "_test_grad_fn"):
        jt._test_grad_fn = jax.jit(jax.value_and_grad(
            jt._loss_fn, has_aux=True), static_argnums=(4,))
    return jt._test_grad_fn


def _feed_reference_features(jt, tt, batch):
    """The port's trainer takes css_tpu's features for this batch."""
    feats = {k: torch.as_tensor(np.array(v)) for k, v in
             jt._featurize(jax.tree.map(jnp.asarray, batch)).items()}
    tt.featurize = lambda _batch: feats
    return feats


def test_featurize_matches(batches):
    jt, _, tt = _pair("adam", batches[0])
    feats = jt._featurize(jax.tree.map(jnp.asarray, batches[0]))
    tfeats = tt.featurize(tt.to_device(batches[0]))
    assert set(tfeats) == set(feats)
    for k in feats:
        np.testing.assert_allclose(tfeats[k].numpy(), np.asarray(feats[k]),
                                   rtol=1e-5, atol=1e-5)


def test_loss_and_gradients_match(batches):
    jt, state, tt = _pair("adam", batches[0])
    batch = batches[0]
    feats = jt._featurize(jax.tree.map(jnp.asarray, batch))
    (jloss, _), jgrads = _grad_fn(jt)(
        state.params, state.batch_stats, feats, jax.random.PRNGKey(0), True)
    tt.model.train()
    tfeats = _feed_reference_features(jt, tt, batch)
    loss, _ = tt.objective(tt.model(tfeats["input"]), tfeats)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=1e-5)
    got = _flat(to_jax({n: p.grad for n, p in
                                  tt.model.named_parameters()})[0])
    want = _flat(jax.tree.map(np.asarray, jgrads))
    assert set(got) == set(want)
    for k in want:
        _close_rel_max(got[k], want[k], 1e-4, floor=1e-3)


def _compare_moments(got, want, rel, skip=()):
    """Adam's mu leaves, then nu leaves, of the two packages; ``skip``:
    indices of parameters (in sorted path order) left out."""
    n = (len(want) - 2) // 2
    for lo in (1, 1 + n):
        floor = 1e-3 * max(float(np.abs(w).max()) for w in want[lo:lo + n])
        for i, (g, w) in enumerate(zip(got[lo:lo + n], want[lo:lo + n])):
            if i not in skip:
                _close_rel_max(g, w, rel, floor=floor)


def _vanishing(jt, state, batch):
    """Indices (sorted path order) of the parameters whose gradient is 0 in
    exact arithmetic: below 1e-6 of the largest gradient."""
    feats = jt._featurize(jax.tree.map(jnp.asarray, batch))
    _, grads = _grad_fn(jt)(
        state.params, state.batch_stats, feats, jax.random.PRNGKey(0), True)
    tops = [float(np.abs(np.asarray(g)).max())
            for g in jax.tree.leaves(grads)]
    return {i for i, t in enumerate(tops) if t < 1e-6 * max(tops)}


def _step(jt, state, tt, batch):
    """One step in each package on the same batch (and features)."""
    state, jm = jt._train_step(state, batch, jax.random.PRNGKey(0))
    _feed_reference_features(jt, tt, batch)
    return state, jm, tt.train_step(batch)


def _compare(jt, state, jmetrics, tt, tmetrics, mean_atol=1e-6):
    np.testing.assert_allclose(float(tmetrics["loss"]),
                               float(jmetrics["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(tmetrics["grad_norm"]),
                               float(jmetrics["grad_norm"]), rtol=1e-4)
    assert bool(tmetrics["finite"]) == bool(jmetrics["finite"])
    np.testing.assert_allclose(tmetrics["lr"], float(jmetrics["lr"]),
                               rtol=1e-6)
    ts = tt.state()
    assert ts.step == int(state.step)
    gs, ws = _flat(ts.batch_stats), _flat(jax.tree.map(np.asarray,
                                                       state.batch_stats))
    assert set(gs) == set(ws)
    for k in ws:
        np.testing.assert_allclose(
            gs[k], ws[k], atol=mean_atol if k.endswith("mean") else 1e-6)
    jleaves = [np.asarray(x) for x in jax.tree.leaves(state.opt_state)]
    assert [np.shape(x) for x in ts.opt_state] == [x.shape for x in jleaves]
    return ts, jleaves


def test_one_adam_step_matches(batches):
    jt, state, tt = _pair("adam", batches[0])
    batch = batches[0]
    feats = jt._featurize(jax.tree.map(jnp.asarray, batch))
    _, jgrads = _grad_fn(jt)(
        state.params, state.batch_stats, feats, jax.random.PRNGKey(0), True)
    state, jm, tm = _step(jt, state, tt, batch)
    assert float(jm["grad_norm"]) > CLIP  # the clip binds
    ts, jleaves = _compare(jt, state, jm, tt, tm)
    assert int(ts.opt_state[0]) == int(jleaves[0]) == 1
    assert int(ts.opt_state[-1]) == int(jleaves[-1]) == 1
    _compare_moments(ts.opt_state, jleaves, 1e-4)
    g = _flat(jax.tree.map(np.asarray, jgrads))
    gp, wp = _flat(ts.params), _flat(jax.tree.map(np.asarray, state.params))
    g_max = max(float(np.abs(v).max()) for v in g.values())
    for k in wp:
        big = np.abs(g[k]) > 1e-3 * max(float(np.abs(g[k]).max()),
                                        1e-3 * g_max)
        np.testing.assert_allclose(gp[k][big], wp[k][big], atol=1e-6)


@pytest.mark.parametrize("optim", ["adam", "sgd"])
def test_three_steps_match(batches, optim):
    sched = dict(lr=1e-2 if optim == "sgd" else 1e-3, warmup=2,
                 min_lr=1e-4)
    jt, state, tt = _pair(optim, batches[0], sched=sched)
    skip = _vanishing(jt, state, batches[0])
    walk = 0.0
    for b in batches:
        state, jm, tm = _step(jt, state, tt, b)
        ts, jleaves = _compare(jt, state, jm, tt, tm,
                               mean_atol=1e-6 + 0.2 * walk)
        walk += tm["lr"] if optim == "adam" else 0.0
    assert int(ts.opt_state[-1]) == int(jleaves[-1]) == 3
    gp, wp = _flat(ts.params), _flat(jax.tree.map(np.asarray, state.params))
    if optim == "sgd":
        assert len(ts.opt_state) == 1
        for k in wp:
            np.testing.assert_allclose(gp[k], wp[k], atol=1e-6)
    else:
        _compare_moments(ts.opt_state, jleaves, 1e-4, skip)


def test_nonfinite_step_keeps_state_and_advances_the_counter(batches):
    jt, state, tt = _pair("adam", batches[0])
    state, _, _ = _step(jt, state, tt, batches[0])
    before = tt.state()
    bad = dict(batches[1])
    bad["mix"] = bad["mix"].copy()
    bad["mix"][0, 100] = np.nan
    state, jm, tm = _step(jt, state, tt, bad)
    assert not bool(jm["finite"]) and not tm["finite"]
    after = tt.state()
    assert after.step == int(state.step) == 2
    for a, b in zip(tree_leaves(after.params) + tree_leaves(
            after.batch_stats) + after.opt_state,
            tree_leaves(before.params) + tree_leaves(before.batch_stats)
            + before.opt_state):
        np.testing.assert_array_equal(a, b)
    assert int(after.opt_state[0]) == int(jax.tree.leaves(
        state.opt_state)[0]) == 1
    # the next finite step agrees with css_tpu's again
    state, jm, tm = _step(jt, state, tt, batches[2])
    _compare(jt, state, jm, tt, tm, mean_atol=1e-6 + 0.2 * 1e-3)


def test_conv_tasnet_sgd_step_matches(batches):
    """The time-domain path (no STFT): one SI-SNR step of SGD on a small
    Conv-TasNet, params element by element (the SGD tolerance)."""
    from css_tpu.models import conv_tasnet as jtas
    from css_tpu.objectives.snr import SiSnrObjective as JSnr
    from css_tpu_torch.models import conv_tasnet as ttas
    from css_tpu_torch.objectives.snr import SiSnrObjective

    conf = {"conv_tasnet_num_filters": 32, "conv_tasnet_conv_channels": 32,
            "conv_tasnet_bottleneck_channels": 16,
            "conv_tasnet_num_blocks": 2, "conv_tasnet_num_layers": 2}
    jt = JTrainer(jtas.ConvTasNet.build_model(conf), JSnr(),
                  JSchedule(lr=1e-3), optim="sgd", grad_thresh=CLIP,
                  input_domain="time", donate=False)
    state = jt.init_state(jax.random.PRNGKey(3), batches[0])
    tm = ttas.build_model(conf)
    tm.load_state_dict(ttas.params_from_jax(
        jax.tree.map(np.asarray, state.params)))
    tt = Trainer(tm, SiSnrObjective(), LRSchedule(lr=1e-3), optim="sgd",
                 grad_thresh=CLIP, input_domain="time", device="cpu")
    state, jm = jt._train_step(state, batches[0], jax.random.PRNGKey(0))
    tm_ = tt.train_step(batches[0])
    np.testing.assert_allclose(float(tm_["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(tm_["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-4)
    gp, wp = _flat(tt.state().params), _flat(jax.tree.map(np.asarray,
                                                         state.params))
    assert set(gp) == set(wp)
    for k in wp:
        np.testing.assert_allclose(gp[k], wp[k], atol=1e-6)
