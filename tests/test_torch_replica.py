"""Replica averaging of the port (``ReplicaAveraging``, one replica per
gloo process) against css_tpu's ``ReplicaAveraging`` on a 2-device mesh
(tests/test_parallel.py's two cases): the JAX package's stacked replica
state split into each rank's own (``models.from_jax(replica=j)``), one
independent SGD step per replica on its rows of the global batch, then
the average over all replicas and over the survivors alone (elastic).
Parameters atol 1e-5 after the step, the averages 1e-5 (css_tpu's own
test holds its average to 1e-6 of its own mean; the steps here already
differ by rounding)."""

import jax
import numpy as np

from css_tpu.models.blstm import BLSTM as JaxBLSTM
from css_tpu.parallel import ReplicaAveraging as JaxRA
from css_tpu.parallel import make_mesh as jax_mesh
from css_tpu_torch.parallel import runner

from tests.test_torch_parallel import (BLSTM_CONF, TIMEOUT_S, _batch,
                                       _jax_trainer, assert_state_close,
                                       write_inputs)


def test_replica_averaging_matches_css_tpu(tmp_path):
    jm = JaxBLSTM(idim=257, num_bins=257, hidden_dim=16, num_layers=1,
                  dropout_rate=0.0)
    ra = JaxRA(_jax_trainer(jm), jax_mesh(data=2, devices=jax.devices()[:2]),
               num_replicas=2)
    batch = _batch(batch_size=4)  # 2 rows per replica
    rngs = jax.random.split(jax.random.PRNGKey(0), 2)
    state = ra.init_state(rngs, {k: v[:2] for k, v in batch.items()})
    p = np.asarray(state.params["embed_linear"]["kernel"])
    assert np.abs(p[0] - p[1]).max() > 1e-4  # distinct initial replicas
    init, batches = write_inputs(tmp_path, state, [batch])
    stepped, m = ra.train_step(state, dict(batch), jax.random.PRNGKey(1))
    alive = [[True, True], [True, False]]
    averaged = [ra.average(stepped, alive=np.array(a)) for a in alive]
    res = runner.run({
        "strategy": "replica", "world": 2, "device": "cpu",
        "model": {"name": "BLSTM", "conf": BLSTM_CONF},
        "objective": {"name": "MSE"},
        "trainer": {"optim": "sgd", "lr": 1e-3, "grad_thresh": 5.0},
        "init": init, "batches": batches, "steps": 1, "averages": alive,
        "timeout_s": TIMEOUT_S}, tmp_path / "run", timeout=120)
    for j, r in enumerate(res):
        np.testing.assert_allclose(r["losses"][0], float(m["loss"][j]),
                                   rtol=1e-5)
        assert_state_close(r["arrays"], ra.replica_state(stepped, j))
        for a, avg in enumerate(averaged):
            assert_state_close(r["arrays"], ra.replica_state(avg, j),
                               prefix=f"avg{a}/")
    # the elastic average over replica 0 alone is replica 0's own state,
    # and so is replica_state(0) on every rank
    for k, v in res[0]["arrays"].items():
        if k.startswith("param/"):
            np.testing.assert_array_equal(res[1]["arrays"]["avg1/" + k], v)
            for r in res:
                np.testing.assert_array_equal(r["arrays"]["replica0/" + k],
                                              v)
