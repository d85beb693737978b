"""The Conformer's tensor parallelism in the port against css_tpu's
(``conformer_tp_spec``, ``DataParallel`` with a TP spec) on the
conftest's virtual CPU devices, the port's ranks as gloo processes on the
CPU (``parallel/runner.py``): the rules pick the same parameters, the
converter's TP shards gather back to the full state, and a data 2 x model
2 step agrees with css_tpu's 2 x 2 mesh at tests/test_torch_parallel.py's
tolerances."""

import re

import jax
import numpy as np
from jax.sharding import PartitionSpec as P

from css_tpu.models.conformer import Conformer as JaxConformer
from css_tpu.parallel import DataParallel as JaxDP
from css_tpu.parallel import conformer_tp_spec as jax_tp_spec
from css_tpu.parallel import make_mesh as jax_mesh
from css_tpu_torch.models import conformer as tconformer
from css_tpu_torch.models import from_jax
from css_tpu_torch.parallel import mesh as tmesh
from css_tpu_torch.parallel import runner

from tests.test_torch_parallel import (CONFORMER_CONF, _batch, _jax_trainer,
                                       assert_state_close, spec_for,
                                       write_inputs)


def test_tp_spec_picks_the_four_families():
    """The port's rules shard exactly the parameters css_tpu's shard (the
    FFN pair, Q/K/V, linear_out), plus the column layers' biases, which
    Flax keeps replicated and the port splits with their outputs."""
    jm = JaxConformer(idim=257, num_bins=257, attention_dim=32,
                      attention_heads=2, linear_units=64, num_blocks=2,
                      kernel_size=5)
    v = jm.init({"params": jax.random.PRNGKey(0)},
                np.zeros((1, 10, 257), np.float32), train=False)
    leaves = jax.tree_util.tree_flatten_with_path(
        jax_tp_spec(v["params"]), is_leaf=lambda s: isinstance(s, P))[0]
    jax_sharded = set()
    for path, s in leaves:
        if s != P():
            name = "/".join(str(getattr(k, "key", k)) for k in path)
            jax_sharded.add(name)
    sd = from_jax(tconformer.Conformer.build_model(
        {"conformer_attention_dim": 32, "conformer_attention_heads": 2,
         "conformer_linear_units": 64, "conformer_num_blocks": 2,
         "conformer_kernel_size": 5}), v["params"], v["batch_stats"])
    spec = tmesh.conformer_tp_spec(sd)
    weights = {k for k in spec if k.endswith(".weight")}
    as_jax = {re.sub(r"encoders\.(\d+)", r"encoders_\1",
                     k[:-len(".weight")]).replace(".", "/") + "/kernel"
              for k in weights}
    assert as_jax == jax_sharded and len(weights) == 2 * 8
    assert {k for k in spec if k.endswith(".bias")} == {
        k[:-len("weight")] + "bias" for k in weights
        if spec[k] == 0}
    # css_tpu's P(None, "model") on (in, out) is the torch weight's dim 0
    assert {spec[k] for k in weights if "w1" in k or "linear_q" in k} == {0}
    assert {spec[k] for k in weights if "w2" in k or "linear_out" in k} == {1}
    # full -> shards -> full
    shards = [from_jax(tconformer.Conformer.build_model(
        {"conformer_attention_dim": 32, "conformer_attention_heads": 2,
         "conformer_linear_units": 64, "conformer_num_blocks": 2,
         "conformer_kernel_size": 5}), v["params"], v["batch_stats"],
        tp_shard=(i, 2)) for i in range(2)]
    back = tmesh.gather_params(shards, spec)
    for k, t in sd.items():
        assert back[k].shape == t.shape and bool((back[k] == t).all()), k


def _grads(arrays):
    return np.concatenate([v.ravel() for k, v in sorted(arrays.items())
                           if k.startswith("grad/")])


def test_dp_tp_step_matches_css_tpu(tmp_path):
    """Data 2 x model 2 (4 gloo ranks): one SGD step against css_tpu's
    DataParallel with its TP spec on a 2 x 2 mesh (loss, every rank's
    gathered parameters), and the gradients, gathered to full shape, and
    their norm against the port's own single-process step (rel-L2 1e-5:
    the port's and css_tpu's gradients differ by more than that on this
    material, ~1e-3 relative, in both the single and the parallel step,
    the per-bin MVN amplifying the two STFTs' rounding in silent bins)."""
    jm = JaxConformer(idim=257, num_bins=257, attention_dim=32,
                      attention_heads=2, linear_units=48, num_blocks=1,
                      kernel_size=5, dropout_rate=0.0)
    batch = _batch()
    rng = jax.random.PRNGKey(0)
    trainer = _jax_trainer(jm)
    tmp = trainer.init_state(rng, batch)
    dp = JaxDP(trainer, jax_mesh(data=2, model=2, devices=jax.devices()[:4]),
               tp_spec=jax_tp_spec(tmp.params))
    state = dp.init_state(rng, batch)
    init, batches = write_inputs(tmp_path, tmp, [batch])
    want, m = dp.train_step(state, dict(batch), rng)
    single = runner.run(spec_for("Conformer", CONFORMER_CONF, init, batches,
                                 strategy="single", world=1),
                        tmp_path / "single")[0]
    res = runner.run(spec_for("Conformer", CONFORMER_CONF, init, batches,
                              world=4, tp=2), tmp_path / "run", timeout=150)
    g1 = _grads(single["arrays"])
    for r in res:
        np.testing.assert_allclose(r["losses"][0], float(m["loss"]),
                                   rtol=1e-5)
        g = _grads(r["arrays"])
        assert np.linalg.norm(g - g1) / np.linalg.norm(g1) <= 1e-5
        np.testing.assert_allclose(r["grad_norms"][0],
                                   single["grad_norms"][0], rtol=1e-5)
        assert_state_close(r["arrays"], want)
        assert r["in_sync"]


def test_tp_step_matches_its_split_order_witness(tmp_path):
    """TP = 2 (2 gloo ranks) against one process computing every TP
    layer as the two ranks do (``runner.split_like_tp``: the same
    products, summed in TP's order): loss and gradients to 1e-6, where
    the witness itself stands within the port's 1e-5 of the plain
    single-process step."""
    jm = JaxConformer(idim=257, num_bins=257, attention_dim=32,
                      attention_heads=2, linear_units=48, num_blocks=2,
                      kernel_size=5, dropout_rate=0.0)
    batch = _batch()
    state = _jax_trainer(jm).init_state(jax.random.PRNGKey(1), batch)
    init, batches = write_inputs(tmp_path, state, [batch])
    conf = dict(CONFORMER_CONF, conformer_num_blocks=2)
    single, witness = (runner.run(spec_for(
        "Conformer", conf, init, batches, strategy="single", world=1,
        split_like_tp=split), tmp_path / f"single{split}")[0]
        for split in (0, 2))
    res = runner.run(spec_for("Conformer", conf, init, batches, world=2,
                              tp=2), tmp_path / "tp", timeout=150)
    gw, g1 = _grads(witness["arrays"]), _grads(single["arrays"])
    assert np.linalg.norm(gw - g1) / np.linalg.norm(g1) <= 1e-5
    np.testing.assert_allclose(witness["losses"], single["losses"],
                               rtol=1e-5)
    for r in res:
        g = _grads(r["arrays"])
        assert np.linalg.norm(g - gw) / np.linalg.norm(gw) <= 1e-6
        np.testing.assert_allclose(r["losses"], witness["losses"],
                                   rtol=1e-6)
