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

import types

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from css_tpu.models import conformer as jc
from css_tpu_torch.models import conformer as tc
from css_tpu_torch.ops import add_layer_norm_cuda as aln
from css_tpu_torch.ops import conv_module_cuda as ccm

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


def test_relative_position_gradient_is_deterministic_on_the_cpu():
    """On the CPU, where index_put_(accumulate=True) adds duplicate
    indices with atomic adds on several threads, the relative-position
    gather's backward gives bit-equal gradients from run to run (the
    card's test is in tests/test_torch_cuda.py), equal to a float64 sum
    to float32 rounding."""
    enc = tc.ConformerEncoder(num_blocks=1)
    torch.nn.init.normal_(enc.pe_k, generator=torch.Generator().manual_seed(1))
    upstream = torch.randn((249, 249, 64),
                           generator=torch.Generator().manual_seed(0))
    threads = torch.get_num_threads()
    torch.set_num_threads(max(threads, 4))
    try:
        grads = []
        for _ in range(4):
            enc.pe_k.grad = None
            (enc.rel_pos(249) * upstream).sum().backward()
            grads.append(enc.pe_k.grad.clone())
    finally:
        torch.set_num_threads(threads)
    assert all(torch.equal(grads[0], g) for g in grads[1:])
    pe64 = enc.pe_k.detach().double().requires_grad_()
    idx = torch.clamp(enc._offsets(249), -enc.maxlen, enc.maxlen - 1)
    (pe64[idx + enc.maxlen] * upstream.double()).sum().backward()
    torch.testing.assert_close(grads[0], pe64.grad.float(), rtol=1e-5,
                               atol=1e-4)


# ------------------------------------------------ the conv module's route
# (ops/conv_module_cuda.py: the kernel runs only on the card, its route and
# operator are held here)


def _forward_before_the_kernel(m, x):
    """ConvModule.forward as it read before the kernel's route."""
    x, k = m._glu(x), m.kernel_size
    if m.causal:
        return m._post(m._dw_conv(F.pad(x, (0, 0, k - 1, 0))))
    return m._post(m._dw_conv(x, (k - 1) // 2))


def _conv(small_pair, causal=False, width=64, kernel=7):
    """A copy of block 1's conv module of the small pair (its BatchNorm
    statistics and GLU parameters moved off their init), offline or
    causal, in eval; at other widths a fresh module."""
    m = tc.ConvModule(width, kernel, causal=causal)
    if width == 64 and kernel == 7:
        m.load_state_dict(small_pair[2].conformer.encoders[1].conv
                          .state_dict())
    return m.eval()


@pytest.mark.parametrize("causal", [False, True], ids=["offline", "causal"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_conv_module_plain_is_the_forward_before_the_kernel(small_pair,
                                                            causal, dtype):
    """conv_module_plain is the module's forward as it was, bit for bit,
    and on the CPU the block's route is x + m(x) with nothing counted: the
    CPU parity with css_tpu is untouched."""
    m = _conv(small_pair, causal)
    x = torch.as_tensor(_x((2, 30, 64), 6)).to(dtype)
    before = ccm.conv_module.launches, ccm.conv_module.plain_routes
    with torch.no_grad():
        want = _forward_before_the_kernel(m, x)
        assert torch.equal(ccm.conv_module_plain(m, x), want)
        assert torch.equal(m(x), want)
        assert torch.equal(ccm.conv_module(m, x), x + want)
    assert (ccm.conv_module.launches,
            ccm.conv_module.plain_routes) == before


def _on_card(shape, dtype=torch.bfloat16):
    """What takes_kernel reads of a CUDA tensor, without a card."""
    return types.SimpleNamespace(device=torch.device("cuda"), dtype=dtype,
                                 ndim=len(shape), shape=tuple(shape))


# case -> (module kwargs for _conv, x, train mode, grad on, takes it)
ROUTES = {
    "bf16": ({}, _on_card((32, 150, 64)), False, False, True),
    "float32": ({}, _on_card((32, 150, 64), torch.float32), False, False,
                True),
    "causal": ({"causal": True}, _on_card((1, 8, 64)), False, False, True),
    "full_width": ({"width": 256, "kernel": 33}, _on_card((32, 150, 256)),
                   False, False, True),
    "causal_even_kernel": ({"causal": True, "kernel": 6},
                           _on_card((2, 20, 64)), False, False, True),
    "cpu": ({}, torch.zeros((2, 20, 64)), False, False, False),
    "train_mode": ({}, _on_card((32, 150, 64)), True, False, False),
    "grad_on": ({}, _on_card((32, 150, 64)), False, True, False),
    "float16": ({}, _on_card((32, 150, 64), torch.float16), False, False,
                False),
    "wide": ({"width": 512}, _on_card((2, 20, 512)), False, False, False),
    "width_not_4n": ({"width": 62}, _on_card((2, 20, 62)), False, False,
                     False),
    "long_kernel": ({"kernel": 35}, _on_card((2, 20, 64)), False, False,
                    False),
    "offline_even_kernel": ({"kernel": 6}, _on_card((2, 20, 64)), False,
                            False, False),
}


@pytest.mark.parametrize("case", sorted(ROUTES))
def test_conv_module_takes_the_kernel_only_where_it_applies(small_pair,
                                                           case):
    """takes_kernel: x on CUDA in float32 or bf16, the module in eval, no
    gradient recorded, C <= 256 a multiple of 4 and K <= 33 with T frames
    kept; every
    other case (training, grad on, float16, widths past the plan, the
    CPU) is the plain route."""
    kwargs, x, train, grad, takes = ROUTES[case]
    m = _conv(small_pair, **kwargs).train(train)
    with torch.set_grad_enabled(grad):
        assert ccm.takes_kernel(m, x) is takes


def test_conv_module_float16_parameters_take_the_plain_route(small_pair):
    m = _conv(small_pair).half()
    with torch.no_grad():
        assert not ccm.takes_kernel(m, _on_card((2, 20, 64)))


def test_conv_module_plain_routes_are_counted_off_the_cpu():
    before = ccm.conv_module.plain_routes
    ccm.count_plain(torch.zeros(1))
    assert ccm.conv_module.plain_routes == before
    ccm.count_plain(_on_card((1, 1, 1)))
    assert ccm.conv_module.plain_routes == before + 1
    ccm.conv_module.plain_routes = before


@pytest.mark.parametrize("causal", [False, True], ids=["offline", "causal"])
def test_conv_module_route_through_the_operator(small_pair, monkeypatch,
                                                causal):
    """With the route forced on the CPU, every block's conv module runs
    through the registered operator (its CPU kernel: the kernel's function
    in float32): the block's operands, padding and eps as the card passes
    them give the plain model's masks."""
    conf = {"conformer_attention_dim": 64, "conformer_attention_heads": 4,
            "conformer_linear_units": 128, "conformer_num_blocks": 2,
            "conformer_kernel_size": 7, "conformer_causal": causal}
    tm = tc.build_model(conf)
    tm.load_state_dict(small_pair[2].state_dict())
    f = torch.as_tensor(np.abs(_x((2, 40, 257), 7)))
    with torch.no_grad():
        _, want = tm.eval()(f)
        calls = []
        op = ccm.conv_module_op

        def counted_op(*args):
            calls.append(args[2:4])
            return op(*args)

        monkeypatch.setattr(ccm, "takes_kernel", lambda m, x: True)
        monkeypatch.setattr(ccm, "conv_module_op", counted_op)
        _, got = tm(f)
    pad = (6, 0) if causal else (3, 3)
    assert calls == [pad, pad]
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("causal", [False, True], ids=["offline", "causal"])
def test_conv_module_operator_is_the_float32_function(small_pair, causal):
    """The operator's CPU kernel against the module in float32, and in
    bf16 within the one rounding at its output of the float32 function
    (the plain bf16 chain, rounding at almost every op, lies farther)."""
    m = _conv(small_pair, causal)
    pad = ccm.padding(m)
    params = [p.detach() for p in ccm._params(m)]
    x = torch.as_tensor(_x((3, 37, 64), 8))
    with torch.no_grad():
        got = ccm.conv_module_op(x, params, *pad, 1e-5, m.bn.eps)
        torch.testing.assert_close(got, x + m(x), atol=1e-6, rtol=1e-6)
        xb = x.bfloat16()
        ref = xb.float() + m(xb.float())
        got = ccm.conv_module_op(xb, params, *pad, 1e-5, m.bn.eps)
        plain = xb + m(xb)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), ref, atol=0, rtol=2.0 ** -8)
    assert (got.float() - ref).abs().max() < (plain.float() - ref).abs().max()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_conv_module_operator_fake_and_schema(small_pair, dtype):
    """The fake kernel gives x's shape and dtype (what torch.export
    traces); opcheck holds the schema, the fake against the CPU kernel and
    no aliasing."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    m = _conv(small_pair)
    params = [p.detach() for p in ccm._params(m)]
    with FakeTensorMode():
        fx = torch.empty((4, 150, 64), dtype=dtype)
        out = ccm.conv_module_op(fx, [torch.empty(p.shape) for p in params],
                                 3, 3, 1e-5, 1e-5)
    assert out.shape == (4, 150, 64) and out.dtype == dtype
    x = torch.as_tensor(_x((2, 20, 64), 9)).to(dtype)
    torch.library.opcheck(ccm.conv_module_op, (x, params, 3, 3, 1e-5, 1e-5))


@pytest.mark.parametrize("case", ["padding", "dtype", "wide", "width_not_4n"])
def test_conv_module_operator_refuses_what_the_kernel_does_not_take(
        small_pair, case):
    width = {"wide": 512, "width_not_4n": 62}.get(case, 64)
    m = _conv(small_pair, width=width)
    params = [p.detach() for p in ccm._params(m)]
    x = torch.zeros((2, 20, params[0].shape[0]))
    pad = (3, 3)
    if case == "padding":
        pad = (3, 2)
    elif case == "dtype":
        params[7] = params[7].double()
    with pytest.raises(ValueError):
        ccm.conv_module_op(x, params, *pad, 1e-5, 1e-5)


# ------------------------------------- the LayerNorms' route (KN)
# (ops/add_layer_norm_cuda.py: the kernel runs only on the card, its route
# and operator are held here)


def _block(small_pair, width=64):
    """A copy of block 1 of the small pair in eval; at other widths a
    fresh block."""
    m = tc.EncoderLayer(width, 4, 128, 7)
    if width == 64:
        m.load_state_dict(small_pair[2].conformer.encoders[1].state_dict())
    return m.eval()


# case -> (block width, x, train mode, grad on, takes it)
KN_ROUTES = {
    "bf16": (64, _on_card((32, 150, 64)), False, False, True),
    "float32": (64, _on_card((32, 150, 64), torch.float32), False, False,
                True),
    "full_width": (256, _on_card((32, 150, 256)), False, False, True),
    "cpu": (64, torch.zeros((2, 20, 64)), False, False, False),
    "train_mode": (64, _on_card((32, 150, 64)), True, False, False),
    "grad_on": (64, _on_card((32, 150, 64)), False, True, False),
    "float16": (64, _on_card((32, 150, 64), torch.float16), False, False,
                False),
    "wide": (2048, _on_card((2, 20, 2048)), False, False, False),
    "width_not_8n": (60, _on_card((2, 20, 60)), False, False, False),
}


@pytest.mark.parametrize("case", sorted(KN_ROUTES))
def test_add_layer_norm_takes_the_kernel_only_where_it_applies(small_pair,
                                                              case):
    """takes_kernel: x on CUDA in float32 or bf16, the LayerNorms in eval
    with float32 parameters, no gradient recorded, C <= 1024 a multiple of
    8; every other case (the CPU, training, grad on, float16, widths past
    the plan) is the composite."""
    width, x, train, grad, takes = KN_ROUTES[case]
    m = _block(small_pair, width).train(train)
    with torch.set_grad_enabled(grad):
        assert aln.takes_kernel(m.norms(), x) is takes


def test_add_layer_norm_float16_parameters_take_the_composite(small_pair):
    m = _block(small_pair)
    m.layer_norm.half()
    with torch.no_grad():
        assert not aln.takes_kernel(m.norms(), _on_card((2, 20, 64)))
        assert aln.takes_kernel(m.norms()[:3], _on_card((2, 20, 64)))


def test_add_layer_norm_plain_routes_are_counted_off_the_cpu(small_pair):
    before = aln.add_layer_norm.launches, aln.add_layer_norm.plain_routes
    with torch.no_grad():  # the CPU: the composite, nothing counted
        small_pair[2](torch.as_tensor(np.abs(_x((1, 20, 257), 3))))
    assert (aln.add_layer_norm.launches,
            aln.add_layer_norm.plain_routes) == before
    aln.count_plain(_on_card((1, 1, 8)))
    assert aln.add_layer_norm.plain_routes == before[1] + 1
    aln.add_layer_norm.plain_routes = before[1]


def _ln(width, seed):
    """A LayerNorm with weight and bias drawn off their init."""
    ln = tc.LayerNorm(width)
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        ln.weight.copy_(torch.as_tensor(
            1.0 + 0.3 * rng.standard_normal(width), dtype=torch.float32))
        ln.bias.copy_(torch.as_tensor(
            0.3 * rng.standard_normal(width), dtype=torch.float32))
    return ln.eval()


@pytest.mark.parametrize("with_y", [False, True], ids=["x", "x_y"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_add_layer_norm_operator_is_the_composite(dtype, with_y):
    """The operator's CPU kernel against the block's composite: r bit-equal
    to ``x + 0.5 * y`` in the compute dtype, and the normalised rows
    equal to the composite LayerNorm of that sum (the same float32
    function; the card's kernel sums in another order, held in
    tests/test_torch_cuda.py)."""
    ln = _ln(64, 10)
    x = (torch.as_tensor(_x((3, 37, 64), 11)) * 4.0).to(dtype)
    y = (torch.as_tensor(_x((3, 37, 64), 12)) * 4.0).to(dtype)
    with torch.no_grad():
        if with_y:
            want_r = x + 0.5 * y
            r, n = aln.add_layer_norm(ln, x, y, 0.5, keep_sum=True)
            assert r.dtype == dtype and torch.equal(r, want_r)
            assert torch.equal(aln.add_layer_norm(ln, x, y, 0.5), n)
        else:
            want_r = x
            n = aln.add_layer_norm(ln, x)
        want = ln(want_r)
    assert n.dtype == dtype
    torch.testing.assert_close(n, want, atol=0, rtol=0)
    ref = F.layer_norm(want_r.double(), (64,), ln.weight.double(),
                       ln.bias.double(), ln.eps)
    torch.testing.assert_close(n.double(), ref, atol=1e-5,
                               rtol=2.0 ** -8 if dtype == torch.bfloat16
                               else 1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("causal", [False, True], ids=["offline", "causal"])
def test_block_route_through_the_operator(small_pair, monkeypatch, causal,
                                          dtype):
    """With the route forced on the CPU, every LayerNorm of every block and
    the embedding's run through the registered operator (its CPU kernel:
    the kernel's function), in the order and with the operands the card
    passes: the model's masks are those of the composite, bit for bit (the
    sums round as the composite's do, the LayerNorm is the same float32
    function)."""
    conf = {"conformer_attention_dim": 64, "conformer_attention_heads": 4,
            "conformer_linear_units": 128, "conformer_num_blocks": 2,
            "conformer_kernel_size": 7, "conformer_causal": causal,
            "bf16": dtype == torch.bfloat16}
    tm = tc.build_model(conf)
    tm.load_state_dict(small_pair[2].state_dict())
    f = torch.as_tensor(np.abs(_x((2, 40, 257), 13)))
    with torch.no_grad():
        _, want = tm.eval()(f)
        calls = []
        op = aln.add_layer_norm_op

        def counted_op(x, y, alpha, weight, bias, eps, keep_sum):
            calls.append((y is not None, alpha, keep_sum, x.dtype))
            return op(x, y, alpha, weight, bias, eps, keep_sum)

        monkeypatch.setattr(aln, "takes_kernel", lambda norms, x: True)
        monkeypatch.setattr(aln, "add_layer_norm_op", counted_op)
        _, got = tm(f)
    block = [(False, 1.0, False, dtype), (True, 0.5, True, dtype),
             (False, 1.0, False, dtype), (True, 0.5, False, dtype)]
    assert calls == [(False, 1.0, False, dtype)] + block * 2
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_add_layer_norm_operator_fake_and_schema(dtype):
    """The fake kernel gives x's shape and dtype, and r's only where it is
    kept (what torch.export traces); opcheck holds the schema, the fake
    against the CPU kernel and no aliasing, with and without y."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    ln = _ln(64, 14)
    w, b = ln.weight.detach(), ln.bias.detach()
    with FakeTensorMode():
        fx = torch.empty((4, 150, 64), dtype=dtype)
        fw, fb = torch.empty(64), torch.empty(64)
        n, r = aln.add_layer_norm_op(fx, fx, 0.5, fw, fb, 1e-5, True)
        n1, r1 = aln.add_layer_norm_op(fx, None, 1.0, fw, fb, 1e-5, False)
    assert n.shape == r.shape == n1.shape == (4, 150, 64)
    assert n.dtype == r.dtype == n1.dtype == dtype and r1.numel() == 0
    x = torch.as_tensor(_x((2, 20, 64), 15)).to(dtype)
    y = torch.as_tensor(_x((2, 20, 64), 16)).to(dtype)
    torch.library.opcheck(aln.add_layer_norm_op,
                          (x, y, 0.5, w, b, 1e-5, True))
    torch.library.opcheck(aln.add_layer_norm_op,
                          (x, None, 1.0, w, b, 1e-5, False))


@pytest.mark.parametrize("case", ["x_float16", "y_dtype", "y_shape",
                                  "weight_dtype", "bias_shape", "wide",
                                  "width_not_8n", "keep_sum_no_y"])
def test_add_layer_norm_operator_refuses_what_the_kernel_does_not_take(
        case):
    width = {"wide": 2048, "width_not_8n": 60}.get(case, 64)
    ln = _ln(width, 17)
    w, b = ln.weight.detach(), ln.bias.detach()
    x = torch.zeros((2, 20, width))
    y = torch.zeros((2, 20, width))
    keep = True
    if case == "x_float16":
        x, y = x.half(), y.half()
    elif case == "y_dtype":
        y = y.bfloat16()
    elif case == "y_shape":
        y = y[:, :10]
    elif case == "weight_dtype":
        w = w.double()
    elif case == "bias_shape":
        b = b[:32]
    elif case == "keep_sum_no_y":
        y = None
    with pytest.raises(ValueError):
        aln.add_layer_norm_op(x, y, 0.5, w, b, 1e-5, keep)
