"""Reference-checkpoint import in the port (``models.*.params_from_torch``,
``css_tpu_torch.cli.import_torch``) against ``css_tpu``'s.

No reference torch checkpoint is in the repo, so the inputs are
state_dicts in the reference's names and layouts written from ``css_tpu``
params trees (Flax init, biases and statistics moved off their init
values) by the helpers below, which are checked first: ``css_tpu``'s own
converter must give the tree back. The Conformer's helper is
``chip_smoke.reference_state_dict``, the one the card run imports the
flagship with. Converters and CLIs are held exactly; the imported
checkpoint's forward in the port against ``css_tpu``'s at the parity
tolerances of ``tests/test_torch_{conformer,blstm}.py`` (1e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from css_tpu.cli import import_torch as jimport
from css_tpu.models import blstm as jb
from css_tpu.models import conformer as jc
from css_tpu.models import conv_tasnet as jt
from css_tpu.trainer.checkpoint import load_checkpoint as jax_load
from css_tpu_torch.cli import import_torch as timport
from css_tpu_torch.models import blstm as tb
from css_tpu_torch.models import build_model, state_dict_from_checkpoint
from css_tpu_torch.models import conformer as tc
from css_tpu_torch.models import conv_tasnet as tt
from css_tpu_torch.trainer.checkpoint import load_checkpoint

CASES = {
    "Conformer": ({"conformer_attention_dim": 32,
                   "conformer_attention_heads": 2,
                   "conformer_linear_units": 48, "conformer_num_blocks": 2,
                   "conformer_kernel_size": 5},
                  ["--num-blocks", "2"]),
    "BLSTM": ({"blstm_hdim": 16, "blstm_num_layers": 2},
              ["--num-layers", "2"]),
    "ConvTasNet-gln": ({"conv_tasnet_num_filters": 16,
                        "conv_tasnet_filter_length": 8,
                        "conv_tasnet_bottleneck_channels": 8,
                        "conv_tasnet_conv_channels": 12,
                        "conv_tasnet_num_blocks": 2,
                        "conv_tasnet_num_layers": 2,
                        "conv_tasnet_norm": "gln"},
                       ["--num-layers", "2", "--num-blocks", "2",
                        "--norm", "gln"]),
    "ConvTasNet-cln": ({"conv_tasnet_num_filters": 16,
                        "conv_tasnet_filter_length": 8,
                        "conv_tasnet_bottleneck_channels": 8,
                        "conv_tasnet_conv_channels": 12,
                        "conv_tasnet_num_blocks": 2,
                        "conv_tasnet_num_layers": 2,
                        "conv_tasnet_norm": "cln"},
                       ["--num-layers", "2", "--num-blocks", "2",
                        "--norm", "cln"]),
}
JAX_MODELS = {"Conformer": jc.Conformer, "BLSTM": jb.BLSTM,
              "ConvTasNet": jt.ConvTasNet}


def _model(case):
    return case.split("-")[0]


def _variables(case, seed=0):
    """A css_tpu model of the case and its variables, every leaf moved off
    its init value by a seeded amount (variances kept positive)."""
    conf = CASES[case][0]
    jm = JAX_MODELS[_model(case)].build_model(conf)
    x = (jnp.ones((1, 1600), jnp.float32) if _model(case) == "ConvTasNet"
         else jnp.ones((1, 20, 257), jnp.float32))
    v = jm.init({"params": jax.random.PRNGKey(seed)}, x, train=False)
    rng = np.random.default_rng(seed)

    def move(path, a):
        a = np.asarray(a, np.float32)
        lo = 0.1 if "var" in jax.tree_util.keystr(path) else -0.2
        return (a + rng.uniform(lo, 0.3, a.shape)).astype(np.float32)

    return jm, jax.tree_util.tree_map_with_path(move, dict(v))


def _t(a, shape=None):
    a = np.ascontiguousarray(np.asarray(a, np.float32))
    return torch.as_tensor(a if shape is None else a.reshape(shape))


def blstm_state_dict(params):
    """The reference BLSTM's names (``blstm.encoders.i.lstm.*_l0``,
    ``_reverse`` for the backward direction); each direction's bias split
    in two exact halves between bias_ih and bias_hh."""
    sd = {"blstm.embed.0.weight": _t(params["embed_linear"]["kernel"].T),
          "blstm.embed.0.bias": _t(params["embed_linear"]["bias"]),
          "blstm.embed.1.weight": _t(params["embed_norm"]["scale"]),
          "blstm.embed.1.bias": _t(params["embed_norm"]["bias"]),
          "linear.weight": _t(params["linear"]["kernel"].T),
          "linear.bias": _t(params["linear"]["bias"])}
    for k in (k for k in params if k.startswith("encoders_")):
        p, e = f"blstm.encoders.{k.split('_')[1]}", params[k]
        sd[f"{p}.layer_norm.weight"] = _t(e["layer_norm"]["scale"])
        sd[f"{p}.layer_norm.bias"] = _t(e["layer_norm"]["bias"])
        for d, suf in (("fwd", ""), ("bwd", "_reverse")):
            sd[f"{p}.lstm.weight_ih_l0{suf}"] = _t(e[f"w_ih_{d}"])
            sd[f"{p}.lstm.weight_hh_l0{suf}"] = _t(e[f"w_hh_{d}"])
            half = np.asarray(e[f"b_{d}"], np.float32) * 0.5
            sd[f"{p}.lstm.bias_ih_l0{suf}"] = _t(half)
            sd[f"{p}.lstm.bias_hh_l0{suf}"] = _t(half)
    return sd


def conv_tasnet_state_dict(params, norm):
    """The reference ConvTasNet's names: 1x1 convs (out, in, 1), the
    depthwise conv (C, 1, K), the encoder (N, 1, L) and decoder (N, 1, L);
    gLN affine (1, C, 1), cLN a LayerNorm (C,)."""
    sd = {}

    def conv1x1(name, p):
        sd[f"{name}.weight"] = _t(np.asarray(p["kernel"]).T[:, :, None])
        sd[f"{name}.bias"] = _t(p["bias"])

    def norm_(name, p, kind):
        if kind == "cln":
            sd[f"{name}.weight"] = _t(p["ln"]["scale"])
            sd[f"{name}.bias"] = _t(p["ln"]["bias"])
        else:
            sd[f"{name}.weight"] = _t(p["scale"], (1, -1, 1))
            sd[f"{name}.bias"] = _t(p["bias"], (1, -1, 1))

    sd["encoder.weight"] = _t(np.asarray(params["encoder_kernel"]).transpose(
        2, 1, 0))
    sd["encoder.bias"] = _t(params["encoder_bias"])
    norm_("LayerN_S", params["layer_n_s"], "cln")
    conv1x1("BottleN_S", params["bottleneck"])
    conv1x1("gen_masks", params["gen_masks"])
    sd["decoder.weight"] = _t(np.asarray(params["decoder_kernel"]).transpose(
        1, 2, 0))
    sd["decoder.bias"] = _t(params["decoder_bias"])
    for k in (k for k in params if k.startswith("separation_")):
        _, r, b = k.split("_")
        p, e = f"separation.{r}.{b}", params[k]
        conv1x1(f"{p}.conv1x1", e["conv1x1"])
        sd[f"{p}.PReLU_1.weight"] = _t(e["prelu1_a"])
        norm_(f"{p}.norm_1", e["norm_1"], norm)
        sd[f"{p}.dwconv.weight"] = _t(np.asarray(e["dw_kernel"]).transpose(
            2, 1, 0))
        sd[f"{p}.dwconv.bias"] = _t(e["dw_bias"])
        sd[f"{p}.PReLU_2.weight"] = _t(e["prelu2_a"])
        norm_(f"{p}.norm_2", e["norm_2"], norm)
        conv1x1(f"{p}.Sc_conv", e["sc_conv"])
    return sd


def reference_state_dict(case, variables):
    model = _model(case)
    if model == "Conformer":
        return chip_smoke.reference_state_dict(
            torch, variables["params"], variables["batch_stats"])
    if model == "BLSTM":
        return blstm_state_dict(variables["params"])
    return conv_tasnet_state_dict(variables["params"], case.split("-")[1])


def _kwargs(case):
    conf = CASES[case][0]
    if _model(case) == "Conformer":
        return {"num_blocks": conf["conformer_num_blocks"]}
    if _model(case) == "BLSTM":
        return {"num_layers": conf["blstm_num_layers"]}
    return {"num_layers": conf["conv_tasnet_num_layers"],
            "num_blocks": conf["conv_tasnet_num_blocks"],
            "norm": conf["conv_tasnet_norm"]}


def _converters(case):
    model = _model(case)
    return ({"Conformer": jc, "BLSTM": jb, "ConvTasNet": jt}[model],
            {"Conformer": tc, "BLSTM": tb, "ConvTasNet": tt}[model])


def _assert_trees_equal(got, want, path=""):
    assert isinstance(got, dict) and set(got) == set(want), path
    for k in want:
        if isinstance(want[k], dict):
            _assert_trees_equal(got[k], want[k], f"{path}/{k}")
        else:
            g, w = np.asarray(got[k]), np.asarray(want[k])
            assert g.shape == w.shape and g.dtype == w.dtype, f"{path}/{k}"
            np.testing.assert_array_equal(g, w, err_msg=f"{path}/{k}")


def _as_tree(variables):
    return {k: jax.tree.map(np.asarray, variables[k])
            for k in ("params", "batch_stats") if k in variables}


@pytest.mark.parametrize("case", sorted(CASES))
def test_reference_naming_helper_round_trips_through_css_tpu(case):
    _, variables = _variables(case)
    sd = reference_state_dict(case, variables)
    jmod, _ = _converters(case)
    _assert_trees_equal(jmod.params_from_torch(sd, **_kwargs(case)),
                        _as_tree(variables))


@pytest.mark.parametrize("case", sorted(CASES))
def test_params_from_torch_equals_css_tpus_leaf_by_leaf(case):
    _, variables = _variables(case, seed=1)
    sd = reference_state_dict(case, variables)
    jmod, tmod = _converters(case)
    _assert_trees_equal(tmod.params_from_torch(sd, **_kwargs(case)),
                        jmod.params_from_torch(sd, **_kwargs(case)))


def _reference_mdl(path, case, seed):
    """A reference-layout ``.mdl``: {model, epoch, loss, objective,
    optimizer, lr_sched}."""
    jm, variables = _variables(case, seed)
    torch.save({"model": reference_state_dict(case, variables), "epoch": 7,
                "loss": 0.25, "objective": {}, "optimizer": {},
                "lr_sched": {}}, path)
    return jm, variables


@pytest.mark.parametrize("case", sorted(CASES))
def test_import_cli_outputs_load_to_equal_trees(case, tmp_path):
    src = tmp_path / "7.1.mdl"
    _reference_mdl(src, case, seed=2)
    argv = ["--model", _model(case)] + CASES[case][1]
    jimport.main([str(src), str(tmp_path / "jax.mdl")] + argv)
    timport.main([str(src), str(tmp_path / "torch.mdl")] + argv)
    for load in (load_checkpoint, jax_load):
        want = load(str(tmp_path / "jax.mdl"))
        got = load(str(tmp_path / "torch.mdl"))
        for key in ("params", "batch_stats"):
            _assert_trees_equal(got.get(key) or {}, want.get(key) or {})
        assert got["epoch"] == want["epoch"] == 7
        assert got["loss"] == want["loss"] == 0.25
        assert got["conf"] == want["conf"] == {
            "imported_from": str(src), "model": _model(case)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_imported_checkpoint_forward_equals_css_tpus(case, tmp_path):
    src = tmp_path / "ref.mdl"
    jm, _ = _reference_mdl(src, case, seed=3)
    argv = ["--model", _model(case)] + CASES[case][1]
    jimport.main([str(src), str(tmp_path / "jax.mdl")] + argv)
    timport.main([str(src), str(tmp_path / "torch.mdl")] + argv)
    want_ckpt = jax_load(str(tmp_path / "jax.mdl"))
    variables = {"params": want_ckpt["params"]}
    if want_ckpt.get("batch_stats"):
        variables["batch_stats"] = want_ckpt["batch_stats"]
    ckpt = load_checkpoint(str(tmp_path / "torch.mdl"))
    tm = build_model(_model(case), CASES[case][0])
    tm.load_state_dict(state_dict_from_checkpoint(_model(case), ckpt))
    rng = np.random.default_rng(4)
    if _model(case) == "ConvTasNet":
        x = rng.standard_normal((2, 1600)).astype(np.float32) * 0.1
    else:
        x = np.abs(rng.standard_normal((2, 24, 257))).astype(np.float32)
    want = jm.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = tm.eval()(torch.as_tensor(x))
    if _model(case) != "ConvTasNet":
        want, got = want[1], got[1]  # the masks
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
