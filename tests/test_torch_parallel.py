"""Data parallelism of the port (``css_tpu_torch.parallel``) against the
JAX package's ``DataParallel`` on the conftest's virtual CPU devices: the
same initial state (the JAX trainer's, converted) and the same global
batch, one step, the port's ranks as gloo processes on the CPU
(``parallel/runner.py``, a time limit on every group and wait); and every
objective's loss on a batch is the mean of its halves', which is what
averaging the ranks' losses assumes. Tensor parallelism is in
tests/test_torch_tp.py.

Tolerances are the JAX package's own (tests/test_parallel.py,
tests/test_bn_dp.py): loss rtol 1e-5, parameters atol 1e-5, BatchNorm
statistics atol 1e-6.
"""

import jax
import numpy as np
import pytest
import torch

from css_tpu.data import SyntheticCorpus
from css_tpu.data.mixer import MixtureSynthesizer
from css_tpu.models.blstm import BLSTM as JaxBLSTM
from css_tpu.models.conformer import Conformer as JaxConformer
from css_tpu.objectives.mse import MeanSquaredError
from css_tpu.parallel import DataParallel as JaxDP
from css_tpu.parallel import make_mesh as jax_mesh
from css_tpu.trainer import LRSchedule, Trainer as JaxTrainer
from css_tpu_torch.parallel import launch
from css_tpu_torch.parallel import mesh as tmesh
from css_tpu_torch.parallel import runner
from css_tpu_torch.trainer.checkpoint import save_checkpoint_dict

BLSTM_CONF = {"blstm_hdim": 16, "blstm_num_layers": 1,
              "blstm_dropout_rate": 0.0}
CONFORMER_CONF = {"conformer_attention_dim": 32,
                  "conformer_attention_heads": 2,
                  "conformer_linear_units": 48, "conformer_num_blocks": 1,
                  "conformer_kernel_size": 5, "conformer_dropout_rate": 0.0}
TRAINER = {"optim": "sgd", "lr": 1e-3, "grad_thresh": 5.0}
TIMEOUT_S = 60.0


def _batch(batch_size=8, seed=0):
    corpus = SyntheticCorpus(num_speakers=4, utts_per_speaker=2,
                             min_dur=2.5, max_dur=4.0)
    loader = MixtureSynthesizer(corpus, batch_size=batch_size,
                                min_window=2.0, max_window=2.0, seed=seed)
    return {k: v for k, v in next(loader).items()
            if k in ("mix", "source1", "source2")}


def _jax_trainer(model, optim="sgd"):
    return JaxTrainer(model, MeanSquaredError(),
                      LRSchedule(lr=1e-3, warmup=0, fixed=0, decay=0.0),
                      optim=optim, grad_thresh=5.0)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def write_inputs(tmp_path, state, batches):
    init = tmp_path / "init.mdl"
    save_checkpoint_dict(str(init), {
        "params": jax.tree.map(np.asarray, state.params),
        "batch_stats": jax.tree.map(np.asarray, state.batch_stats or {}),
        "epoch": 0})
    runner.save_batches(tmp_path / "batches.npz", batches)
    return str(init), str(tmp_path / "batches.npz")


def spec_for(name, conf, init, batches, **kw):
    return dict({"strategy": "dp", "world": 2, "tp": 1, "device": "cpu",
                 "model": {"name": name, "conf": conf},
                 "objective": {"name": "MSE"}, "trainer": TRAINER,
                 "init": init, "batches": batches, "steps": 1,
                 "timeout_s": TIMEOUT_S}, **kw)


def assert_state_close(arrays, state, prefix="", atol=1e-5, stats_atol=1e-6):
    params = _flat(jax.tree.map(np.asarray, state.params))
    for path, want in params.items():
        np.testing.assert_allclose(arrays[f"{prefix}param/{path}"], want,
                                   atol=atol, err_msg=path)
    for path, want in _flat(jax.tree.map(np.asarray,
                                         state.batch_stats or {})).items():
        np.testing.assert_allclose(arrays[f"{prefix}stats/{path}"], want,
                                   atol=stats_atol, err_msg=path)


def test_mesh_shapes_and_refusal():
    """One process, no group: the 1 x 1 mesh; a grid that is not the
    world raises as css_tpu's make_mesh does."""
    m = tmesh.make_mesh()
    assert m.shape == {"data": 1, "model": 1} and m.data_group is None
    with pytest.raises(ValueError, match="mesh 1x2 != 1 ranks"):
        tmesh.make_mesh(data=1, model=2)
    assert tmesh.split_batch({"mix": np.arange(8)[:, None], "win": 3},
                             4, 2)["mix"].ravel().tolist() == [4, 5]


C8, C1 = 8, 1  # cards a host shows


@pytest.mark.parametrize("peers,devices,backend", [
    # two hosts of 8 cards, 8 ranks on each: every rank a card of its own
    ([("a", "cuda", C8)] * 8 + [("b", "cuda", C8)] * 8,
     [f"cuda:{i}" for i in range(8)] * 2, "nccl"),
    # two hosts of one card, one rank on each
    ([("a", "cuda", C1), ("b", "cuda", C1)], ["cuda:0", "cuda:0"], "nccl"),
    # ranks interleaved over two hosts of 2 cards
    ([("a", "cuda", 2), ("b", "cuda", 2)] * 2,
     ["cuda:0", "cuda:0", "cuda:1", "cuda:1"], "nccl"),
    # two ranks sharing one host's one card
    ([("a", "cuda", C1)] * 2, ["cuda:0", "cuda:0"], "gloo"),
    # 16 ranks on one host of 8 cards
    ([("a", "cuda", C8)] * 16, [f"cuda:{i % 8}" for i in range(16)],
     "gloo"),
    # an explicit card, the same for both ranks
    ([("a", "cuda:1", C8)] * 2, ["cuda:1", "cuda:1"], "gloo"),
    # the CPU, where the tests run
    ([("a", "cpu", 0)] * 2, ["cpu", "cpu"], "gloo"),
])
def test_backend_follows_the_ranks_of_each_host(peers, devices, backend):
    """The rule of ``plan_ranks``: a rank's card is its local rank (among
    the ranks of its host) modulo its host's cards, and NCCL when every
    rank has a card of its own, on any number of hosts; the world size is
    not compared with one host's cards."""
    got, b = launch.plan_ranks(peers)
    assert [str(d) for d in got] == devices and b == backend


def test_rank_device_without_a_card_raises():
    with pytest.raises(RuntimeError, match="no card is visible"):
        launch.plan_ranks([("a", "cuda", 0)])


def _jax_model(name):
    if name == "BLSTM":
        return JaxBLSTM(idim=257, num_bins=257, hidden_dim=16, num_layers=1,
                        dropout_rate=0.0)
    return JaxConformer(idim=257, num_bins=257, attention_dim=32,
                        attention_heads=2, linear_units=48, num_blocks=1,
                        kernel_size=5, dropout_rate=0.0)


@pytest.fixture(scope="module")
def dp_runs(tmp_path_factory):
    """css_tpu's DataParallel step and the port's world-2 step, per model,
    run once for the tests of this module."""
    cache = {}

    def run(name):
        if name not in cache:
            tmp = tmp_path_factory.mktemp(name)
            batch = _batch()
            rng = jax.random.PRNGKey(0)
            dp = JaxDP(_jax_trainer(_jax_model(name)),
                       jax_mesh(data=2, devices=jax.devices()[:2]))
            state = dp.init_state(rng, batch)
            init, batches = write_inputs(tmp, state, [batch])
            want, m = dp.train_step(state, dict(batch), rng)
            conf = BLSTM_CONF if name == "BLSTM" else CONFORMER_CONF
            res = runner.run(spec_for(name, conf, init, batches), tmp / "run",
                             timeout=120)
            cache[name] = (want, m, res, tmp, init, batches)
        return cache[name]

    return run


@pytest.mark.parametrize("name", ["BLSTM", "Conformer"])
def test_data_parallel_matches_css_tpu(dp_runs, name):
    """World 2 against css_tpu's DataParallel on a 2-device mesh: one SGD
    step's loss and parameters; for the Conformer the BatchNorm running
    statistics, which must be the global batch's."""
    want, m, res, *_ = dp_runs(name)
    assert [r["backend"] for r in res] == ["gloo", "gloo"]
    for r in res:
        np.testing.assert_allclose(r["losses"][0], float(m["loss"]),
                                   rtol=1e-5)
        assert_state_close(r["arrays"], want)
        assert r["in_sync"]


def test_global_batchnorm_statistics_under_dp(dp_runs):
    """The running mean and variance after a world-2 step are the global
    batch's (css_tpu's single-device step, atol 1e-6); with per-rank
    statistics (the control) they are not, and neither is the gradient."""
    _, _, res, tmp, init, batches = dp_runs("Conformer")
    jm = _jax_model("Conformer")
    batch = _batch()
    rng = jax.random.PRNGKey(0)
    trainer = _jax_trainer(jm)
    want, _ = trainer._train_step(trainer.init_state(rng, batch),
                                  dict(batch), rng)
    glob = res[0]["arrays"]
    local = runner.run(spec_for("Conformer", CONFORMER_CONF, init, batches,
                                local_bn=True),
                       tmp / "local", timeout=120)[0]["arrays"]
    bn = _flat(jax.tree.map(np.asarray, want.batch_stats))
    assert bn
    worst = 0.0
    for path, w in bn.items():
        np.testing.assert_allclose(glob[f"stats/{path}"], w, atol=1e-6)
        worst = max(worst, float(np.abs(local[f"stats/{path}"] - w).max()))
    assert worst > 1e-4  # per-rank statistics differ from the global ones
    g = np.concatenate([v.ravel() for k, v in sorted(glob.items())
                        if k.startswith("grad/")])
    c = np.concatenate([v.ravel() for k, v in sorted(local.items())
                        if k.startswith("grad/")])
    assert np.linalg.norm(c - g) / np.linalg.norm(g) > 1e-5


def _objective_inputs(name, rows, rng_seed=0, b=4, t=40, f=33, n=2560):
    """(outputs, featurized batch) of the examples ``rows`` of a fixed
    random batch of ``b``, laid out as a rank holding those rows would lay
    them out (the consistency pair stacks the second crops after the
    first)."""
    rng = np.random.default_rng(rng_seed)
    mag = rng.uniform(0, 1, (b, t, f)).astype(np.float32)
    srcs = rng.uniform(0, 0.5, (2, b, t, f)).astype(np.float32)
    masks = rng.uniform(0, 1, (2, b, t, f, 3)).astype(np.float32)
    wav = (rng.standard_normal((3, b, n)) * 0.1).astype(np.float32)
    est = (rng.standard_normal((b, 2, n)) * 0.1).astype(np.float32)
    r = list(rows)
    if name == "SNR":
        return torch.as_tensor(est[r]), {
            "source1": torch.as_tensor(wav[1, r]),
            "source2": torch.as_tensor(wav[2, r])}
    if name == "MaskSNR":
        from css_tpu_torch.ops.stft import stft

        _, tt, ff = stft(torch.as_tensor(wav[0, :1]), 512, 256).shape
        m = torch.as_tensor(rng.uniform(0, 1, (b, tt, ff, 3)).astype(
            np.float32)[r])
        return (None, m), {"mix_wav": torch.as_tensor(wav[0, r]),
                           "source1": torch.as_tensor(wav[1, r]),
                           "source2": torch.as_tensor(wav[2, r])}
    pair = name.endswith("consistency")
    m = np.concatenate([masks[0, r], masks[1, r]]) if pair else masks[0, r]
    inp = np.concatenate([mag[r], mag[r]]) if pair else mag[r]
    m = torch.as_tensor(m)
    y = torch.einsum("btfs,btf->bstf", m[..., :2], torch.as_tensor(inp))
    return (y, m), {"input": torch.as_tensor(inp),
                    "source1": torch.as_tensor(srcs[0, r]),
                    "source2": torch.as_tensor(srcs[1, r])}


@pytest.mark.parametrize("name,conf", [
    ("MSE", {}), ("MSE noise", {"mse_noise_weight": 0.3}),
    ("MSE order", {"mse_order_weight": 0.5}),
    ("MSE consistency", {"mse_consistency_weight": 0.1,
                         "mse_consistency_frames": 5}),
    ("MaskSNR", {"masksnr_mag_weight": 0.2}), ("SNR", {})])
def test_objectives_reduce_as_a_mean_over_examples(name, conf):
    """Data parallelism averages the ranks' losses: every objective's loss
    on a batch must be the mean of its losses on equal halves."""
    from css_tpu_torch.objectives import build_objective

    obj = build_objective(name.split()[0], conf)
    full = obj(*_objective_inputs(name, range(4)))[0]
    halves = [obj(*_objective_inputs(name, rows))[0]
              for rows in (range(2), range(2, 4))]
    np.testing.assert_allclose(float(full), float(sum(halves)) / 2,
                               rtol=1e-5)
