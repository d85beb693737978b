"""The models in training mode against css_tpu's ``train=True``, and
Conv-TasNet.

Dropout 0 (the two packages draw their masks from different generators);
BatchNorm then runs on the batch's statistics and the LSTM through the
differentiable loop. Small sizes: Conformer 2 blocks x 64, 4 heads,
kernel 7; BLSTM hidden 32; Conv-TasNet 2 x 2 blocks of 32 channels.
Random-init weights from css_tpu, numpy-seeded inputs, float32 on the CPU.

Tolerances, float32 (summation order only): outputs 1e-4 absolute and
relative; gradients 1e-4 of their tensor's largest magnitude, or of 1e-2
of the model's largest where that is smaller (the k bias, the biases ahead
of BatchNorm and Conv-TasNet's decoder bias under SI-SNR have a zero
gradient in exact arithmetic, float32 rounding in both packages); the updated BatchNorm statistics 1e-6
absolute. bfloat16 (the recipe's --bf16): the two packages round at the
same places but sum in other orders, so the masks differ about as much as
bf16 differs from float32 (0.1 max and 1e-2 mean absolute, as
tests/test_torch_conformer.py) and the loss 1e-2 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from css_tpu.models import blstm as jb
from css_tpu.models import conformer as jc
from css_tpu.models import conv_tasnet as jt
from css_tpu.objectives.snr import SiSnrObjective as JSnr
from css_tpu_torch.models import (build_model, from_jax, init_variables,
                                  to_jax)
from css_tpu_torch.models import blstm as tb
from css_tpu_torch.models import conformer as tc
from css_tpu_torch.models import conv_tasnet as tt
from css_tpu_torch.models.conformer import set_dropout_generator
from css_tpu_torch.objectives.snr import SiSnrObjective

CONFORMER = {"conformer_attention_dim": 64, "conformer_attention_heads": 4,
             "conformer_linear_units": 128, "conformer_num_blocks": 2,
             "conformer_kernel_size": 7, "conformer_dropout_rate": 0.0}
BLSTM = {"blstm_hdim": 32, "blstm_num_layers": 2, "blstm_dropout_rate": 0.0}
TASNET = {"conv_tasnet_num_filters": 32, "conv_tasnet_conv_channels": 32,
          "conv_tasnet_bottleneck_channels": 16, "conv_tasnet_num_blocks": 2,
          "conv_tasnet_num_layers": 2}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _grads_close(tmodel, jgrads):
    got = _flat(to_jax({n: p.grad for n, p in
                        tmodel.named_parameters()})[0])
    want = _flat(jax.tree.map(np.asarray, jgrads))
    assert set(got) == set(want)
    floor = 1e-2 * max(float(np.abs(w).max()) for w in want.values())
    for k in want:
        scale = max(float(np.abs(want[k]).max()), floor)
        assert np.abs(got[k] - want[k]).max() <= 1e-4 * scale, k


def _features(seed, b=2, t=50):
    rng = np.random.default_rng(seed)
    return np.abs(rng.standard_normal((b, t, 257))).astype(np.float32)


def _mask_model_pair(jmodule, conf, seed):
    jm = jmodule.build_model(conf) if hasattr(jmodule, "build_model") \
        else None
    f = _features(seed)
    v = jm.init({"params": jax.random.PRNGKey(seed)}, jnp.asarray(f))
    v = jax.tree.map(np.asarray, v)
    tm = build_model(type(jm).__name__, conf)
    tm.load_state_dict(from_jax(tm, v["params"], v.get("batch_stats")))
    return jm, v, tm


def _train_forward_and_grads(jm, v, tm, f):
    def loss_fn(params):
        variables = {"params": params}
        if v.get("batch_stats"):
            variables["batch_stats"] = v["batch_stats"]
            (y, m), upd = jm.apply(variables, jnp.asarray(f), train=True,
                                   mutable=["batch_stats"])
        else:
            y, m = jm.apply(variables, jnp.asarray(f), train=True)
            upd = {}
        return jnp.mean(jnp.square(y)) + jnp.mean(m), (y, m, upd)

    (jloss, (y, m, upd)), g = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(v["params"])
    tm.train()
    ty, tmask = tm(torch.as_tensor(f))
    tloss = torch.mean(torch.square(ty)) + torch.mean(tmask)
    tloss.backward()
    return (jloss, y, m, upd, g), (tloss, ty, tmask)


@pytest.mark.parametrize("family,conf", [(jc.Conformer, CONFORMER),
                                         (jb.BLSTM, BLSTM)],
                         ids=["conformer", "blstm"])
def test_train_mode_matches(family, conf):
    jm, v, tm = _mask_model_pair(family, conf, 0)
    f = _features(1)
    (jloss, y, m, upd, g), (tloss, ty, tmask) = _train_forward_and_grads(
        jm, v, tm, f)
    np.testing.assert_allclose(tmask.detach().numpy(), np.asarray(m),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(y),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(float(tloss.detach()), float(jloss),
                               rtol=1e-5)
    _grads_close(tm, g)
    if upd:
        got = _flat(to_jax(dict(tm.named_buffers()))[1])
        want = _flat(jax.tree.map(np.asarray, upd["batch_stats"]))
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], atol=1e-6)
            # the running statistics moved from their init
            assert np.abs(want[k] - _flat(v["batch_stats"])[k]).max() > 1e-3


@pytest.mark.parametrize("family,conf", [(jc.Conformer, CONFORMER),
                                         (jb.BLSTM, BLSTM)],
                         ids=["conformer", "blstm"])
def test_train_mode_bf16_stays_near(family, conf):
    jm, v, _ = _mask_model_pair(family, dict(conf, bf16=True), 2)
    tm = build_model(type(jm).__name__, dict(conf, bf16=True))
    tm.load_state_dict(from_jax(tm, v["params"], v.get("batch_stats")))
    f = _features(3)
    (jloss, _, m, _, _), (tloss, _, tmask) = _train_forward_and_grads(
        jm, v, tm, f)
    diff = np.abs(tmask.detach().numpy() - np.asarray(m))
    assert diff.max() <= 0.1 and diff.mean() <= 1e-2
    np.testing.assert_allclose(float(tloss.detach()), float(jloss),
                               rtol=1e-2)
    for p in tm.parameters():
        assert p.grad.dtype == torch.float32 and torch.isfinite(p.grad).all()


def test_differentiable_lstm_scan_matches():
    rng = np.random.default_rng(4)
    xw = rng.standard_normal((3, 9, 32)).astype(np.float32)
    w_hh = (0.3 * rng.standard_normal((8, 32))).astype(np.float32)
    for reverse in (False, True):
        def f(x, w):
            return jnp.sum(jnp.sin(jb.lstm_scan(x, w, 8, reverse=reverse,
                                                differentiable=True)))
        want, (gx, gw) = jax.value_and_grad(f, argnums=(0, 1))(
            jnp.asarray(xw), jnp.asarray(w_hh))
        x = torch.as_tensor(xw).requires_grad_(True)
        w = torch.as_tensor(w_hh).requires_grad_(True)
        got = torch.sum(torch.sin(tb.lstm_scan(x, w, 8, reverse=reverse,
                                               differentiable=True)))
        got.backward()
        np.testing.assert_allclose(float(got.detach()), float(want),
                                   rtol=1e-5)
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(gx),
                                   atol=1e-5)
        np.testing.assert_allclose(w.grad.numpy(), np.asarray(gw),
                                   atol=1e-5)


def test_dropout_needs_a_generator_and_scales_kept_values():
    tm = tc.Conformer.build_model(dict(CONFORMER,
                                       conformer_dropout_rate=0.5))
    tm.train()
    f = torch.as_tensor(_features(5))
    with pytest.raises(RuntimeError, match="generator"):
        tm(f)
    gen = torch.Generator().manual_seed(0)
    set_dropout_generator(tm, gen)
    drop = tm.conformer.embed_drop
    x = torch.ones(20000)
    y = drop(x)
    assert set(torch.unique(y).tolist()) == {0.0, 2.0}
    assert abs(float((y == 0).float().mean()) - 0.5) < 0.02
    gen.manual_seed(0)
    a = tm(f)[1]
    gen.manual_seed(0)
    np.testing.assert_array_equal(tm(f)[1].detach().numpy(),
                                  a.detach().numpy())
    tm.eval()
    np.testing.assert_array_equal(tm(f)[1].detach().numpy(),
                                  tm(f)[1].detach().numpy())


@pytest.mark.parametrize("norm", ["gln", "cln"])
def test_conv_tasnet_forward_matches(norm):
    conf = dict(TASNET, conv_tasnet_norm=norm)
    jm = jt.ConvTasNet.build_model(conf)
    x = (0.1 * np.random.default_rng(6).standard_normal((2, 1600))
         ).astype(np.float32)
    v = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(1),
                                         jnp.asarray(x)))
    tm = build_model("ConvTasNet", conf)
    tm.load_state_dict(tt.params_from_jax(v["params"]))
    want = np.asarray(jm.apply(v, jnp.asarray(x)))
    got = tm(torch.as_tensor(x)).detach().numpy()
    assert got.shape == want.shape == (2, 2, 1600)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4)
    back = _flat(to_jax(tm.state_dict())[0])
    for k, a in _flat(v["params"]).items():
        np.testing.assert_array_equal(back[k], a)


def test_conv_tasnet_snr_gradients_match():
    jm = jt.ConvTasNet.build_model(TASNET)
    rng = np.random.default_rng(7)
    src = (0.1 * rng.standard_normal((2, 2, 1600))).astype(np.float32)
    mix = src.sum(1)
    batch = {"source1": src[:, 0], "source2": src[:, 1]}
    v = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(2),
                                         jnp.asarray(mix)))

    def loss_fn(params):
        return JSnr()(jm.apply({"params": params}, jnp.asarray(mix)),
                      {k: jnp.asarray(a) for k, a in batch.items()})[0]

    want, g = jax.jit(jax.value_and_grad(loss_fn))(v["params"])
    tm = build_model("ConvTasNet", TASNET)
    tm.load_state_dict(tt.params_from_jax(v["params"]))
    loss, _ = SiSnrObjective()(tm(torch.as_tensor(mix)),
                               {k: torch.as_tensor(a)
                                for k, a in batch.items()})
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-4)
    _grads_close(tm, g)


def test_init_variables_covers_every_model():
    for name, conf in (("Conformer", CONFORMER), ("BLSTM", BLSTM),
                       ("ConvTasNet", TASNET)):
        tm = build_model(name, conf)
        params, stats = init_variables(tm, 0)
        tm.load_state_dict(from_jax(tm, params, stats))
        again = init_variables(tm, 0)[0]
        for a, b in zip(_flat(params).values(), _flat(again).values()):
            np.testing.assert_array_equal(a, b)
        assert all(np.isfinite(p.detach().numpy()).all()
                   for p in tm.parameters())
