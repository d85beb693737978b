"""The ported Conformer against the Flax one, submodule by submodule.

Small size (2 blocks, width 64, 4 heads, kernel 7). Flax random-init
parameters (with BatchNorm statistics and scalar GLU parameters drawn away
from their init values) are carried across by ``params_from_jax``; inputs
come from numpy seeds.

Tolerances, float32: the JAX package pins float32 matmuls to full
precision (css_tpu/__init__.py:37), so the only difference is summation
order: 1e-4 absolute and relative, on activations of order 1-10.
bfloat16: both packages round at the same places but their kernels sum in
other orders and round bias additions differently, so they differ by about
as much as bf16 differs from float32 (measured: max 0.055, mean 2.5e-3 on
masks up to 4.5, against max 0.05 between bf16 and float32): 0.1 max and
1e-2 mean absolute.
"""

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from css_tpu.models import conformer as jc
from css_tpu_torch.models import conformer as tc

SMALL = dict(attention_dim=64, attention_heads=4, linear_units=128,
             num_blocks=2, kernel_size=7)
ATOL = RTOL = 1e-4


def _perturb(tree, rng, lo, hi):
    return jax.tree.map(
        lambda a: (np.asarray(a) + rng.uniform(lo, hi, np.shape(a))
                   ).astype(np.float32), tree)


@pytest.fixture(scope="module")
def small_pair():
    """(flax model, flax variables, torch model) with the same weights."""
    rng = np.random.default_rng(0)
    jm = jc.Conformer(**SMALL)
    f = np.abs(rng.standard_normal((2, 40, 257))).astype(np.float32)
    v = jm.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(f))
    params = jax.tree.map(np.asarray, v["params"])
    for i in range(SMALL["num_blocks"]):
        conv = params["conformer"][f"encoders_{i}"]["conv"]
        conv.update(_perturb({k: conv[k] for k in
                              ("pw1_w", "pw1_b", "pw2_w", "pw2_b", "dw_bias")},
                             rng, -0.3, 0.3))
        conv["bn"] = _perturb(conv["bn"], rng, -0.2, 0.2)
    batch_stats = _perturb(v["batch_stats"], rng, 0.1, 0.5)
    variables = {"params": params, "batch_stats": batch_stats}
    tm = tc.Conformer(**SMALL)
    tm.load_state_dict(tc.params_from_jax(params, batch_stats))
    return jm, variables, tm.eval()


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _sub(variables, *path):
    p, b = variables["params"], variables["batch_stats"]
    for k in path:
        p = p[k]
        b = b.get(k, {}) if isinstance(b, dict) else {}
    return ({"params": p, "batch_stats": b} if b else {"params": p})


def _torch_sub(tm, *path):
    m = tm
    for k in path:
        if k.startswith("encoders_"):
            m = m.encoders[int(k.split("_")[1])]
        else:
            m = getattr(m, k)
    return m


def test_params_from_jax_shapes(small_pair):
    _, variables, tm = small_pair
    sd = tc.params_from_jax(variables["params"], variables["batch_stats"])
    assert set(sd) == set(tm.state_dict())
    blk = "conformer.encoders.0."
    assert sd[blk + "conv.dw_conv.weight"].shape == (64, 1, 7)
    assert sd[blk + "self_attn.linear_q.weight"].shape == (64, 64)
    assert sd["conformer.embed_linear.weight"].shape == (64, 257)
    assert sd["conformer.pe_k"].shape == (2000, 16)
    assert sd[blk + "conv.pw1_w"].shape == (2,)
    np.testing.assert_array_equal(
        sd[blk + "conv.bn.running_var"].numpy(),
        variables["batch_stats"]["conformer"]["encoders_0"]["conv"]["bn"]["var"])
    np.testing.assert_array_equal(
        sd[blk + "feed_forward_in.w1.weight"].numpy(),
        variables["params"]["conformer"]["encoders_0"]["feed_forward_in"][
            "w1"]["kernel"].T)


FLAX_SUBMODULES = {
    "feed_forward_in": lambda: jc.FeedForward(64, 128, 0.1),
    "conv": lambda: jc.ConvModule(64, 7, 0.1),
    "layer_norm": lambda: flax.linen.LayerNorm(epsilon=1e-5),
}


@pytest.mark.parametrize("name", sorted(FLAX_SUBMODULES))
def test_block_submodules_match(small_pair, name):
    _, variables, tm = small_pair
    path = ("conformer", "encoders_1", name)
    x = _x((2, 30, 64))
    want = np.asarray(FLAX_SUBMODULES[name]().apply(_sub(variables, *path),
                                                   jnp.asarray(x)))
    got = _torch_sub(tm, *path)(torch.as_tensor(x)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_attention_matches(small_pair):
    jm, variables, tm = small_pair
    x = _x((2, 30, 64))
    enc = jc.ConformerEncoder(idim=257, **{k: SMALL[k] for k in SMALL})
    pe_k = variables["params"]["conformer"]["pe_k"]
    rel = np.arange(30)[:, None] - np.arange(30)[None, :]
    pos_k = np.asarray(jc._relpos_band(jnp.asarray(pe_k), rel, enc.maxlen))
    att = jc.RelPosMultiHeadAttention(4, 64, 0.1)
    want = np.asarray(att.apply(
        _sub(variables, "conformer", "encoders_0", "self_attn"),
        jnp.asarray(x), jnp.asarray(pos_k)))
    tpos = tm.conformer.rel_pos(30)
    np.testing.assert_array_equal(tpos.detach().numpy(), pos_k)
    got = tm.conformer.encoders[0].self_attn(torch.as_tensor(x), tpos)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=ATOL,
                               rtol=RTOL)


def test_encoder_layer_and_encoder_match(small_pair):
    jm, variables, tm = small_pair
    x = _x((2, 30, 257), 2)
    enc = jc.ConformerEncoder(idim=257, **SMALL)
    want = np.asarray(enc.apply(_sub(variables, "conformer"), jnp.asarray(x)))
    got = tm.conformer(torch.as_tensor(x)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("t", [40, 150])
def test_conformer_matches_float32(small_pair, t):
    jm, variables, tm = small_pair
    f = np.abs(_x((2, t, 257), 3))
    y_want, m_want = jm.apply(variables, jnp.asarray(f))
    with torch.no_grad():
        y_got, m_got = tm(torch.as_tensor(f))
    assert m_got.shape == (2, t, 257, 3) and y_got.shape == (2, 2, t, 257)
    np.testing.assert_allclose(m_got.numpy(), np.asarray(m_want), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(y_got.numpy(), np.asarray(y_want), atol=ATOL,
                               rtol=RTOL)


def test_conformer_matches_bfloat16(small_pair):
    _, variables, _ = small_pair
    conf = {"conformer_attention_dim": 64, "conformer_attention_heads": 4,
            "conformer_linear_units": 128, "conformer_num_blocks": 2,
            "conformer_kernel_size": 7, "bf16": True}
    jm = jc.Conformer.build_model(conf)
    tm = tc.build_model(conf)
    assert tm.compute_dtype == torch.bfloat16
    tm.load_state_dict(tc.params_from_jax(variables["params"],
                                          variables["batch_stats"]))
    f = np.abs(_x((2, 150, 257), 4))
    _, m_want = jm.apply(variables, jnp.asarray(f))
    with torch.no_grad():
        _, m_got = tm.eval()(torch.as_tensor(f))
    assert m_got.dtype == torch.float32
    np.testing.assert_allclose(m_got.numpy(), np.asarray(m_want), atol=0.1)
    assert np.abs(m_got.numpy() - np.asarray(m_want)).mean() < 1e-2
    # and bf16 is not silently float32
    f32 = tc.build_model(dict(conf, bf16=False))
    f32.load_state_dict(tm.state_dict())
    with torch.no_grad():
        _, m32 = f32.eval()(torch.as_tensor(f))
    assert float((m32 - m_got).abs().max()) > 1e-4


def test_causal_conf_builds_the_causal_model(small_pair):
    """conformer_causal (ported): the flagship-layout weights load into the
    causal model unchanged, and its masks are css_tpu's causal model's
    (banded attention, left-padded conv, running MVN), float32."""
    _, variables, _ = small_pair
    conf = {"conformer_attention_dim": 64, "conformer_attention_heads": 4,
            "conformer_linear_units": 128, "conformer_num_blocks": 2,
            "conformer_kernel_size": 7, "conformer_causal": True,
            "conformer_left_context": 12}
    jm = jc.Conformer.build_model(conf)
    tm = tc.build_model(conf)
    assert tm.causal and tm.left_context == 12
    tm.load_state_dict(tc.params_from_jax(variables["params"],
                                          variables["batch_stats"]))
    f = np.abs(_x((2, 30, 257), 5))
    _, m_want = jm.apply(variables, jnp.asarray(f))
    with torch.no_grad():
        _, m_got = tm.eval()(torch.as_tensor(f))
    np.testing.assert_allclose(m_got.numpy(), np.asarray(m_want), atol=ATOL,
                               rtol=RTOL)
