"""Window-sharded separation of the port (``executor/sharded.py``, one
process, shards over a device list) against css_tpu's
``ShardedSeparation`` on the conftest's virtual CPU mesh, on
tests/test_sharded_inference.py's recordings and model (BLSTM hidden
16): per-window masks, magnitudes and stitched streams 1e-5, window
counts that do not divide into the shards (padded, trimmed), and the
stitcher's ``valid=`` against css_tpu's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from css_tpu.executor.sharded import ShardedSeparation as JaxSharded
from css_tpu.executor.stitcher import Stitcher as JaxStitcher
from css_tpu.models.blstm import BLSTM as JaxBLSTM
from css_tpu.parallel import make_mesh
from css_tpu_torch.executor.separator import Separator
from css_tpu_torch.executor.sharded import ShardedSeparation
from css_tpu_torch.executor.stitcher import Stitcher
from css_tpu_torch.models import blstm


@pytest.fixture(scope="module")
def models():
    jm = JaxBLSTM(idim=257, num_bins=257, hidden_dim=16, num_layers=1,
                  dropout_rate=0.0)
    v = jm.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 10, 257)),
                train=False)
    tm = blstm.BLSTM.build_model({"blstm_hdim": 16, "blstm_num_layers": 1})
    tm.load_state_dict(blstm.params_from_jax(
        jax.tree.map(np.asarray, v["params"])))
    return jm, v, tm.eval()


def test_get_connect_valid_matches_css_tpu():
    rng = np.random.default_rng(3)
    masks = rng.uniform(0, 1, (6, 150, 257, 3)).astype(np.float32)
    perms = np.array([[0, 1], [1, 0], [1, 0], [0, 1], [1, 0]])
    valid = np.array([True, True, True, True, False, False])
    masks[~valid] = 0.0
    want = JaxStitcher().get_connect(jnp.asarray(perms), jnp.asarray(masks),
                                     jnp.asarray(valid))
    got = Stitcher(device="cpu").get_connect(
        torch.as_tensor(perms), torch.as_tensor(masks), torch.as_tensor(valid))
    plain = Stitcher(device="cpu").get_connect(torch.as_tensor(perms),
                                               torch.as_tensor(masks))
    for g, w, p in zip(got, want, plain):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)
    # the padded windows' floors and counts would show without valid=
    assert max(float((g - p).abs().max()) for g, p in zip(got, plain)) > 1e-5


@pytest.mark.parametrize("shards,seconds,seed", [(8, 12, 0), (8, 10, 1),
                                                 (3, 10, 1)])
def test_sharded_matches_css_tpu(models, shards, seconds, seed):
    """12 s: 12 windows, 10 s: 10; neither divides by 8, nor 10 by 3."""
    jm, v, tm = models
    wav = (np.random.default_rng(seed).standard_normal(16000 * seconds)
           * 0.05).astype(np.float32)
    mesh = make_mesh(data=shards, devices=jax.devices()[:shards])
    want, wmasks, wmags = JaxSharded(jm, v, mesh).separate(wav)
    sharded = ShardedSeparation(tm, ["cpu"] * shards)
    assert sharded.n_shards == shards
    got, masks, mags = sharded.separate(wav)
    n_win = (len(wav) - sharded.win) // sharded.hop + 1
    assert n_win % shards and masks.shape[0] == n_win
    np.testing.assert_allclose(masks.numpy(), wmasks, atol=1e-5)
    np.testing.assert_allclose(mags.numpy(), wmags, rtol=1e-5, atol=1e-5)
    frames = (n_win - 1) * sharded.stitcher.hop_frames + masks.shape[1]
    for g, w in zip(got, want):
        assert g.shape[0] == frames == w.shape[0]
        np.testing.assert_allclose(g.numpy(), w, atol=1e-5)
    # and the port's own unsharded separator + stitcher
    m1, g1 = Separator(tm, batch_size=8, device="cpu").separate(wav)
    np.testing.assert_allclose(masks.numpy(), m1.numpy(), atol=1e-5)
    for g, r in zip(got, Stitcher(device="cpu")(m1, g1)):
        np.testing.assert_allclose(g.numpy(), r.numpy()[:frames], atol=1e-5)
