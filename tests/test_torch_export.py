"""``torch.export`` serving in the port (``css_tpu_torch/cli/export.py``,
``Separator(None, exported_path=...)``) against the live port and against
``css_tpu``'s StableHLO export, and K2 as a registered op.

Small sizes: a BLSTM of hidden 32 x 2 layers and a Conformer of 2 blocks
x 64 (4 heads, kernel 7), Flax random-init weights carried across by
``params_from_jax``; windows of (4, 150, 257) float32 features.

Tolerances: the port's artifact against the port's live forward runs the
same ops on the same inputs, 1e-6 (measured 0.0). Against ``css_tpu``'s
exported forward: the parity tolerances of ``tests/test_torch_blstm.py``
and ``tests/test_torch_conformer.py``, 1e-4 absolute and relative
(summation order only). The served separators: 1e-5, the bound
``tests/test_export.py`` holds ``css_tpu``'s served separator to.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from css_tpu.cli import export as jexport
from css_tpu.executor.separator import Separator as JaxSeparator
from css_tpu.models import blstm as jb
from css_tpu.models import conformer as jc
from css_tpu_torch.cli import export as texport
from css_tpu_torch.executor.separator import Separator
from css_tpu_torch.models import blstm as tb
from css_tpu_torch.models import conformer as tc
from css_tpu_torch.ops import lstm_cuda

SHAPE = (4, 150, 257)
CONFS = {
    "BLSTM": {"blstm_hdim": 32, "blstm_num_layers": 2},
    "Conformer": {"conformer_attention_dim": 64,
                  "conformer_attention_heads": 4,
                  "conformer_linear_units": 128, "conformer_num_blocks": 2,
                  "conformer_kernel_size": 7},
}
JAX_MODELS = {"BLSTM": jb.BLSTM, "Conformer": jc.Conformer}
TORCH_MODELS = {"BLSTM": tb.BLSTM, "Conformer": tc.Conformer}
PARITY_ATOL = PARITY_RTOL = 1e-4
SERVED_ATOL = 1e-5


def _pair(name, conf, seed=0):
    """(flax model, its variables, the port's model) with one set of
    weights, biases and statistics moved off their init values."""
    rng = np.random.default_rng(seed)
    jm = JAX_MODELS[name].build_model(conf)
    v = jm.init({"params": jax.random.PRNGKey(seed)},
                jnp.ones((1, 20, 257), jnp.float32), train=False)

    def perturb(path, a):
        a = np.asarray(a, np.float32)
        key = jax.tree_util.keystr(path)
        if any(s in key for s in ("bias", "scale", "'b_", "mean", "pw")):
            a = a + rng.uniform(-0.2, 0.2, a.shape).astype(np.float32)
        if "var" in key:
            a = a + rng.uniform(0.1, 0.5, a.shape).astype(np.float32)
        return a

    variables = jax.tree_util.tree_map_with_path(perturb, dict(v))
    tm = TORCH_MODELS[name].build_model(conf)
    if name == "Conformer":
        tm.load_state_dict(tc.params_from_jax(variables["params"],
                                              variables["batch_stats"]))
    else:
        tm.load_state_dict(tb.params_from_jax(variables["params"]))
    return jm, variables, tm.eval()


@pytest.fixture(scope="module", params=sorted(CONFS))
def exported(request, tmp_path_factory):
    """Per model: the flax pair, the port's artifact (path, program) and
    css_tpu's exported call, at SHAPE."""
    name = request.param
    jm, variables, tm = _pair(name, CONFS[name])
    d = tmp_path_factory.mktemp(name)
    program = texport.export_forward(tm, *SHAPE, device="cpu")
    path = d / "fwd.pt2"
    torch.export.save(program, path)
    blob = jexport.export_forward(jm, variables, *SHAPE)
    (d / "fwd.stablehlo").write_bytes(blob)
    return {"name": name, "tm": tm, "jm": jm, "variables": variables,
            "path": path, "program": program,
            "jax_call": jexport.load_exported(d / "fwd.stablehlo")}


def _feats(seed=1):
    return np.abs(np.random.default_rng(seed).standard_normal(SHAPE)).astype(
        np.float32)


def test_exported_forward_matches_the_live_port(exported):
    f = torch.as_tensor(_feats())
    served = texport.load_exported(exported["path"])
    assert served.input_shape == SHAPE
    with torch.no_grad():
        got = served(f)
        want = torch.clamp(exported["tm"](f)[1], max=1.0)
    assert got.shape == want.shape == SHAPE + (3,)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=0)


def test_exported_forward_matches_css_tpus_export(exported):
    f = _feats(2)
    want = np.asarray(exported["jax_call"](jnp.asarray(f)))
    with torch.no_grad():
        got = texport.load_exported(exported["path"])(
            torch.as_tensor(f)).numpy()
    np.testing.assert_allclose(got, want, atol=PARITY_ATOL, rtol=PARITY_RTOL)


def test_graph_nodes_of_the_port(exported):
    """The BLSTM's graph holds K2 as one op node per (layer, direction)
    and no unrolled recurrence (the plain loop's sigmoids); the
    Conformer's holds no op of the port's."""
    targets = [str(n.target) for n in exported["program"].graph.nodes
               if n.op == "call_function"]
    ops = [t for t in targets if t.startswith("css_tpu_torch.")]
    if exported["name"] == "BLSTM":
        layers = CONFS["BLSTM"]["blstm_num_layers"]
        assert ops == ["css_tpu_torch.lstm_fused.default"] * (2 * layers)
        assert not any("sigmoid" in t or "tanh" in t for t in targets)
    else:
        assert ops == []


def test_served_separator_matches_the_live_separator(exported, tmp_path):
    wav = np.random.default_rng(3).standard_normal(16000 * 6).astype(
        np.float32) * 0.05
    live = Separator(exported["tm"], batch_size=SHAPE[0], device="cpu")
    served = Separator(None, exported_path=str(exported["path"]),
                       batch_size=SHAPE[0], device="cpu")
    m_live, g_live = live.separate(wav)
    m_served, g_served = served.separate(wav)
    torch.testing.assert_close(m_served, m_live, atol=1e-6, rtol=0)
    torch.testing.assert_close(g_served, g_live, atol=0, rtol=0)


def test_served_separator_matches_css_tpus_served_separator(tmp_path):
    """tests/test_export.py's BLSTM (hidden 16, 1 layer) served by both
    packages from their own artifacts of the same weights."""
    conf = {"blstm_hdim": 16, "blstm_num_layers": 1}
    jm, variables, tm = _pair("BLSTM", conf, seed=5)
    (tmp_path / "j.stablehlo").write_bytes(
        jexport.export_forward(jm, variables, *SHAPE))
    torch.export.save(texport.export_forward(tm, *SHAPE, device="cpu"),
                      tmp_path / "t.pt2")
    wav = np.random.default_rng(1).standard_normal(16000 * 6).astype(
        np.float32) * 0.05
    want_m, want_g = JaxSeparator(
        None, None, exported_path=str(tmp_path / "j.stablehlo"),
        batch_size=SHAPE[0]).separate(wav)
    got_m, got_g = Separator(None, exported_path=str(tmp_path / "t.pt2"),
                             batch_size=SHAPE[0], device="cpu").separate(wav)
    np.testing.assert_allclose(got_m.numpy(), want_m, atol=SERVED_ATOL)
    np.testing.assert_allclose(got_g.numpy(), want_g, atol=SERVED_ATOL)


def test_a_shape_the_artifact_does_not_take_raises(exported):
    wav = np.zeros(16000 * 4, np.float32)
    with pytest.raises(ValueError, match=r"\(4, 150, 257\).*\(3, 150, 257\)"):
        Separator(None, exported_path=str(exported["path"]), batch_size=3,
                  device="cpu").separate(wav)
    with pytest.raises(ValueError, match=r"\(4, 150, 257\).*\(4, 87, 257\)"):
        Separator(None, exported_path=str(exported["path"]), eval_win=1.4,
                  eval_hop=0.7, batch_size=4, device="cpu").separate(wav)
    with pytest.raises(ValueError, match="exactly one"):
        Separator(exported["tm"], exported_path=str(exported["path"]),
                  device="cpu")


@pytest.mark.parametrize("case", ["fwd", "rev", "state", "bf16"])
def test_lstm_op_passes_opcheck(case):
    """torch.library.opcheck on K2's op with its CPU kernel: schema,
    fake kernel, no aliasing, dispatch."""
    rng = np.random.default_rng(7)
    b, t, h = 3, 5, 8
    xw = torch.as_tensor(rng.standard_normal((b, t, 4 * h)).astype(
        np.float32))
    w_hh = torch.as_tensor((rng.standard_normal((h, 4 * h)) / 3).astype(
        np.float32))
    h0 = c0 = None
    if case == "state":
        h0 = torch.as_tensor(rng.uniform(-0.5, 0.5, (b, h)).astype(np.float32))
        c0 = torch.as_tensor(rng.uniform(-0.5, 0.5, (b, h)).astype(np.float32))
    if case == "bf16":
        xw, w_hh = xw.bfloat16(), w_hh.bfloat16()
    torch.library.opcheck(lstm_cuda.lstm_op,
                          (xw, w_hh, h, case == "rev", h0, c0))
    hs, h_t, c_t = lstm_cuda.lstm_op(xw, w_hh, h, case == "rev", h0, c0)
    assert c_t.dtype == torch.float32
    if case == "rev":
        # the last step of a reverse scan is frame 0
        torch.testing.assert_close(
            hs, lstm_cuda.lstm_plain(xw, w_hh, h, reverse=True), atol=0,
            rtol=0)
        torch.testing.assert_close(h_t, hs[:, 0], atol=0, rtol=0)
        return
    want, (wh, wc) = lstm_cuda.lstm_plain(
        xw, w_hh, h, state=None if h0 is None else (h0, c0),
        return_state=True)
    for got, ref in ((hs, want), (h_t, wh), (c_t, wc)):
        torch.testing.assert_close(got, ref, atol=0, rtol=0)


def test_export_cli_writes_what_the_separator_serves(tmp_path):
    """``python -m css_tpu_torch.cli.export`` on a css_tpu-written BLSTM
    checkpoint, the JAX CLI's flags plus --device: the artifact takes the
    separator's (batch, frames, bins) and serves the live masks."""
    from css_tpu.trainer.checkpoint import save_checkpoint_dict

    conf = CONFS["BLSTM"]
    _, variables, tm = _pair("BLSTM", conf, seed=2)
    ckpt = tmp_path / "b.mdl"
    save_checkpoint_dict(str(ckpt), {"params": variables["params"],
                                     "conf": conf})
    texport.main(["--checkpoint", str(ckpt), "--model", "BLSTM", "--output",
                  str(tmp_path / "b.pt2"), "--batch-size", "4", "--device",
                  "cpu"])
    wav = np.random.default_rng(6).standard_normal(16000 * 5).astype(
        np.float32) * 0.05
    served = Separator(None, exported_path=str(tmp_path / "b.pt2"),
                       batch_size=4, device="cpu")
    assert served.exported.input_shape == SHAPE
    got = served.separate(wav)[0]
    want = Separator(tm, batch_size=4, device="cpu").separate(wav)[0]
    torch.testing.assert_close(got, want, atol=1e-6, rtol=0)
