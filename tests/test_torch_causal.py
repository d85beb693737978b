"""The causal models and their streaming methods against css_tpu's.

Carried LSTM state (``lstm_scan(state=, return_state=)``), the causal
BLSTM's ``stream``, the causal Conformer's offline forward, train step and
``stream`` (banded attention, left-padded conv, rolled KV cache, conv
tail), chunk by chunk on uneven chunks, with css_tpu's random-init weights
carried across by ``params_from_jax`` and numpy-seeded inputs, float32 on
the CPU. Small sizes: LSTM hidden 32, BLSTM hidden 32 x 2 layers,
Conformer 2 blocks x 64, 4 heads, kernel 7 (and 1), left context 16.

Tolerances, float32 (summation order only): hidden states and carries
1e-5 absolute and relative (values in (-1, 1); measured < 1e-6); masks
and outputs 1e-4 absolute and relative, as tests/test_torch_conformer.py;
chained stream chunks against one call of the same package 2e-4 / 2e-5,
the bound of tests/test_hop_streaming.py; gradients as
tests/test_torch_train_models.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from css_tpu.models import blstm as jb
from css_tpu.models import conformer as jc
from css_tpu_torch.models import build_model, from_jax, to_jax
from css_tpu_torch.models.blstm import lstm_scan
from css_tpu_torch.ops import lstm_cuda

H = 32
CHUNKS = ((0, 7), (7, 8), (8, 25), (25, 45))
CONFORMER = {"conformer_attention_dim": 64, "conformer_attention_heads": 4,
             "conformer_linear_units": 128, "conformer_num_blocks": 2,
             "conformer_kernel_size": 7, "conformer_dropout_rate": 0.0,
             "conformer_causal": True, "conformer_left_context": 16}
BLSTM = {"blstm_hdim": 32, "blstm_num_layers": 2, "blstm_dropout_rate": 0.0,
         "blstm_causal": True}


def _lstm_inputs(b, t, seed):
    rng = np.random.default_rng(seed)
    xw = rng.standard_normal((b, t, 4 * H)).astype(np.float32)
    w_hh = (rng.standard_normal((H, 4 * H)) * 0.2).astype(np.float32)
    h0 = np.tanh(rng.standard_normal((b, H))).astype(np.float32)
    c0 = rng.standard_normal((b, H)).astype(np.float32)
    return xw, w_hh, h0, c0


@pytest.mark.parametrize("differentiable", [False, True],
                         ids=["eval_k2", "train_loop"])
def test_lstm_scan_carried_state_matches_css_tpu(differentiable):
    """Both routes of lstm_scan with an initial (h, c), chained over
    uneven chunks, against css_tpu's scan over the whole sequence."""
    xw, w_hh, h0, c0 = _lstm_inputs(3, 20, seed=1)
    want, (wh, wc) = jb.lstm_scan(jnp.asarray(xw), jnp.asarray(w_hh), H,
                                  state=(jnp.asarray(h0), jnp.asarray(c0)),
                                  return_state=True)
    state = (torch.as_tensor(h0), torch.as_tensor(c0))
    parts = []
    for lo, hi in ((0, 5), (5, 6), (6, 6), (6, 20)):
        hs, state = lstm_scan(torch.as_tensor(xw[:, lo:hi]),
                              torch.as_tensor(w_hh), H,
                              differentiable=differentiable, state=state,
                              return_state=True)
        assert hs.shape == (3, hi - lo, H)
        parts.append(hs)
    got = torch.cat(parts, dim=1).detach()
    assert state[1].dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(state[0].detach().numpy(), np.asarray(wh),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(state[1].detach().numpy(), np.asarray(wc),
                               atol=1e-5, rtol=1e-5)


def test_lstm_plain_chained_equals_one_call():
    """K2's plain version: chunks chained through its returned state give
    one call's output bit for bit (the same float32 carry)."""
    xw, w_hh, h0, c0 = _lstm_inputs(2, 24, seed=2)
    xw, w_hh = torch.as_tensor(xw), torch.as_tensor(w_hh)
    state = (torch.as_tensor(h0), torch.as_tensor(c0))
    whole, (h_t, c_t) = lstm_cuda.lstm_plain(xw, w_hh, H, state=state,
                                             return_state=True)
    parts = []
    for lo in range(0, 24, 8):
        hs, state = lstm_cuda.lstm_plain(xw[:, lo:lo + 8], w_hh, H,
                                         state=state, return_state=True)
        parts.append(hs)
    torch.testing.assert_close(torch.cat(parts, dim=1), whole, atol=0,
                               rtol=0)
    torch.testing.assert_close(state[0], h_t, atol=0, rtol=0)
    torch.testing.assert_close(state[1], c_t, atol=0, rtol=0)


def _pair(family, conf, seed=0, t=20):
    jm = family.build_model(conf)
    v = jm.init({"params": jax.random.PRNGKey(seed)},
                jnp.zeros((1, t, 257)), train=False)
    v = jax.tree.map(np.asarray, v)
    tm = build_model(type(jm).__name__, conf)
    tm.load_state_dict(from_jax(tm, v["params"], v.get("batch_stats")))
    return jm, v, tm.eval()


def _feats(seed, t=45):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((1, t, 257)) ** 2).astype(np.float32)


def _stream_both(jm, v, tm, x, chunks):
    jcarry, tcarry = jm.stream_init(1), tm.stream_init(1)
    jouts, touts = [], []
    for lo, hi in chunks:
        m, jcarry = jm.apply(v, jnp.asarray(x[:, lo:hi]), jcarry,
                             method="stream")
        jouts.append(np.asarray(m))
        m, tcarry = tm.stream(torch.as_tensor(x[:, lo:hi]), tcarry)
        assert m.shape == (1, hi - lo, 257, 3)
        touts.append(m.numpy())
    return (np.concatenate(jouts, axis=1), jcarry,
            np.concatenate(touts, axis=1), tcarry)


def _carries_close(jcarry, tcarry):
    jl = jax.tree.leaves(jcarry)
    tl = [t for t in jax.tree.leaves(tcarry, is_leaf=torch.is_tensor)]
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        a = np.asarray(a)
        assert a.shape == tuple(b.shape)
        if a.dtype == bool:
            np.testing.assert_array_equal(b.numpy(), a)
        else:
            np.testing.assert_allclose(b.float().numpy(), a.astype(np.float32),
                                       atol=1e-4, rtol=1e-4)


def test_blstm_stream_matches_css_tpu():
    """The causal BLSTM's stream, chained over uneven chunks, against
    css_tpu's: masks and the carried (MVN, (h, c) per layer)."""
    jm, v, tm = _pair(jb.BLSTM, BLSTM)
    x = _feats(3)
    jm_out, jcarry, tm_out, tcarry = _stream_both(jm, v, tm, x, CHUNKS)
    np.testing.assert_allclose(tm_out, jm_out, atol=1e-4, rtol=1e-4)
    _carries_close(jcarry, tcarry)
    # and the port's chained stream is its own offline causal forward
    with torch.no_grad():
        _, full = tm(torch.as_tensor(x))
    np.testing.assert_allclose(tm_out, full.numpy(), atol=2e-5, rtol=2e-4)


@pytest.mark.parametrize("kernel", [7, 1], ids=["kernel7", "kernel1"])
def test_causal_conformer_forward_matches_css_tpu(kernel):
    conf = dict(CONFORMER, conformer_kernel_size=kernel)
    jm, v, tm = _pair(jc.Conformer, conf)
    assert tm.causal and tm.left_context == 16
    x = _feats(4, t=40)
    _, want = jm.apply(v, jnp.asarray(x), train=False)
    with torch.no_grad():
        _, got = tm(torch.as_tensor(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("kernel", [7, 1], ids=["kernel7", "kernel1"])
def test_causal_conformer_stream_matches_css_tpu(kernel):
    """Chained chunks, one longer than the left context (25-45: 20 > 16),
    against css_tpu's stream, its carries (KV caches with their valid
    flags, conv tails, MVN) and the port's own causal forward."""
    conf = dict(CONFORMER, conformer_kernel_size=kernel)
    jm, v, tm = _pair(jc.Conformer, conf)
    x = _feats(5)
    jm_out, jcarry, tm_out, tcarry = _stream_both(jm, v, tm, x, CHUNKS)
    np.testing.assert_allclose(tm_out, jm_out, atol=1e-4, rtol=1e-4)
    _carries_close(jcarry, tcarry)
    assert tcarry["layers"][0][1].shape == (1, kernel - 1, 64)
    with torch.no_grad():
        _, full = tm(torch.as_tensor(x))
    np.testing.assert_allclose(tm_out, full.numpy(), atol=2e-5, rtol=2e-4)


def _flat(tree, prefix=""):
    out = {}
    for k, val in tree.items():
        if isinstance(val, dict):
            out.update(_flat(val, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(val)
    return out


@pytest.mark.parametrize("kernel", [7, 1], ids=["kernel7", "kernel1"])
def test_causal_conformer_train_step_matches_css_tpu(kernel):
    """One training forward (BatchNorm on the batch, dropout 0) and its
    loss and gradients against css_tpu's train=True."""
    conf = dict(CONFORMER, conformer_kernel_size=kernel)
    jm, v, tm = _pair(jc.Conformer, conf)
    f = np.abs(np.random.default_rng(6).standard_normal((2, 30, 257))
               ).astype(np.float32)

    def loss_fn(params):
        (y, m), _ = jm.apply({"params": params,
                              "batch_stats": v["batch_stats"]},
                             jnp.asarray(f), train=True,
                             mutable=["batch_stats"])
        return jnp.mean(jnp.square(y)) + jnp.mean(m)

    jloss, g = jax.value_and_grad(loss_fn)(v["params"])
    tm.train()
    y, m = tm(torch.as_tensor(f))
    tloss = torch.mean(torch.square(y)) + torch.mean(m)
    tloss.backward()
    np.testing.assert_allclose(float(tloss.detach()), float(jloss),
                               rtol=1e-5)
    got = _flat(to_jax({n: p.grad for n, p in tm.named_parameters()})[0])
    want = _flat(jax.tree.map(np.asarray, g))
    assert set(got) == set(want)
    floor = 1e-2 * max(float(np.abs(w).max()) for w in want.values())
    for k in want:
        scale = max(float(np.abs(want[k]).max()), floor)
        assert np.abs(got[k] - want[k]).max() <= 1e-4 * scale, k


def test_stream_refuses_a_model_that_is_not_causal():
    jm, v, tm = _pair(jc.Conformer, dict(CONFORMER, conformer_causal=False))
    with pytest.raises(ValueError, match="causal"):
        tm.stream(torch.zeros(1, 4, 257), tm.stream_init(1))
    _, _, tb = _pair(jb.BLSTM, dict(BLSTM, blstm_causal=False))
    with pytest.raises(ValueError, match="causal"):
        tb.stream(torch.zeros(1, 4, 257), tb.stream_init(1))
    xw, w_hh, h0, c0 = _lstm_inputs(1, 4, seed=0)
    with pytest.raises(ValueError, match="reverse"):
        lstm_scan(torch.as_tensor(xw), torch.as_tensor(w_hh), H,
                  reverse=True, return_state=True)


def test_cli_train_trains_the_causal_conformer(tmp_path):
    """cli.train --conformer-causal: the conf carries the flag, the loss is
    finite, and the checkpoint builds a causal model that streams."""
    import json

    from css_tpu_torch.cli import train as ttrain
    from css_tpu_torch.cli.separate import load_model

    ttrain.main(["--synthetic-data", "--synthetic-speakers", "4",
                 "--synthetic-utts", "2", "--batch-size", "2",
                 "--batches-per-epoch", "2", "--num-epochs", "1",
                 "--optim", "adam", "--lr", "1e-3", "--warmup", "2",
                 "--conformer-num-blocks", "2",
                 "--conformer-attention-dim", "64",
                 "--conformer-linear-units", "128",
                 "--conformer-kernel-size", "7", "--conformer-causal",
                 "--conformer-left-context", "16",
                 "--min-window-size", "1.0", "--max-window-size", "1.0",
                 "--validate-batches", "1", "--num-workers", "1",
                 "--expdir", str(tmp_path), "--device", "cpu"])
    with open(tmp_path / "train.1.jsonl") as fh:
        recs = [json.loads(line) for line in fh]
    losses = [r[k] for r in recs for k in r if "loss" in k
              and isinstance(r[k], float)]
    assert losses and np.isfinite(losses).all()
    model = load_model(str(tmp_path / "1.1.mdl")).eval()
    assert model.causal and model.left_context == 16
    masks, _ = model.stream(torch.ones(1, 5, 257), model.stream_init(1))
    assert masks.shape == (1, 5, 257, 3) and torch.isfinite(masks).all()
