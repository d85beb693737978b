"""PIT, the objectives and the LR schedule of the port against css_tpu's.

Inputs from numpy seeds, float32 on the CPU (css_tpu pins float32 matmuls
to full precision). Tolerances: losses 1e-5 relative and gradients with
respect to the model outputs 1e-5 of their largest magnitude (float32
sums in another order; MaskSNR's STFT and iSTFT are products of 512-tap
frames, and its SI-SNR a log of ratios: 1e-4 there); the chosen PIT
permutations and the schedule's rates equal (the rates to 1e-6 relative:
XLA's exp and numpy's differ in the last bit).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from css_tpu.objectives.masksnr import MaskSiSnr as JMaskSnr
from css_tpu.objectives.mse import MeanSquaredError as JMse
from css_tpu.objectives.snr import SiSnrObjective as JSnr
from css_tpu.ops import pit as jpit
from css_tpu.trainer.lr_schedule import LRSchedule as JSchedule
from css_tpu_torch.objectives import OBJECTIVES, build_objective
from css_tpu_torch.objectives.masksnr import MaskSiSnr
from css_tpu_torch.objectives.mse import MeanSquaredError
from css_tpu_torch.objectives.snr import SiSnrObjective
from css_tpu_torch.ops import pit
from css_tpu_torch.trainer.lr_schedule import LRSchedule


def _rng(seed):
    return np.random.default_rng(seed)


@pytest.mark.parametrize("k", [2, 3])
def test_permutation_table_is_the_references(k):
    np.testing.assert_array_equal(pit.permutations_array(k),
                                  jpit.permutations_array(k))


@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("fn", ["mse_pairwise", "l1_pairwise"])
def test_batch_pit_loss_matches(k, fn):
    rng = _rng(k)
    est = rng.standard_normal((5, k, 7, 9)).astype(np.float32)
    ref = est[:, rng.permutation(k)] + 0.3 * rng.standard_normal(
        est.shape).astype(np.float32)
    want, wperm = jpit.batch_pit_loss(jnp.asarray(est), jnp.asarray(ref),
                                      getattr(jpit, fn))
    got, gperm = pit.batch_pit_loss(torch.as_tensor(est),
                                    torch.as_tensor(ref), getattr(pit, fn))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    np.testing.assert_array_equal(gperm.numpy(), np.asarray(wperm))
    one, perm = pit.pit_loss(torch.as_tensor(est[1]), torch.as_tensor(ref[1]),
                             loss_fn=getattr(pit, fn), return_permutation=True)
    jone, jperm = jpit.pit_loss(jnp.asarray(est[1]), jnp.asarray(ref[1]),
                                loss_fn=getattr(jpit, fn),
                                return_permutation=True)
    np.testing.assert_allclose(float(one), float(jone), rtol=1e-5)
    np.testing.assert_array_equal(perm.numpy(), np.asarray(jperm))


def _mask_batch(seed, b=4, k=2, t=40, f=33, sources_far=True):
    """Magnitude targets, masks and a mix magnitude; sources with distinct
    centroids (sources_far) or close ones."""
    rng = _rng(seed)
    src = np.abs(rng.standard_normal((k, b, t, f))).astype(np.float32)
    if sources_far:
        src[0, ..., f // 2:] *= 0.05  # low centroid
    noise = np.abs(rng.standard_normal((b, t, f))).astype(np.float32) * 0.2
    mix = src.sum(0) + noise
    masks = rng.uniform(0, 1, (b, t, f, k + 1)).astype(np.float32)
    batch = {"input": mix, **{f"source{i + 1}": src[i] for i in range(k)}}
    return masks, batch


def _value_and_grad_jax(obj, masks, batch, k):
    def f(m):
        y = jnp.einsum("btfs,btf->bstf", m[..., :k], jnp.asarray(
            batch["input"])[..., : m.shape[2]])
        loss, aux = obj((y, m), {kk: jnp.asarray(v) for kk, v in
                                 batch.items()})
        return loss, aux
    (loss, aux), g = jax.value_and_grad(f, has_aux=True)(jnp.asarray(masks))
    return float(loss), np.asarray(g), aux


def _value_and_grad_torch(obj, masks, batch, k):
    m = torch.as_tensor(masks).requires_grad_(True)
    tb = {kk: torch.as_tensor(v) for kk, v in batch.items()}
    y = torch.einsum("btfs,btf->bstf", m[..., :k],
                     tb["input"][..., : m.shape[2]])
    loss, aux = obj((y, m), tb)
    loss.backward()
    return float(loss.detach()), m.grad.numpy(), aux


MSE_MODES = {
    "plain": {},
    "noise": {"noise_weight": 0.3},
    "order": {"order_weight": 0.7},
    "order_close": {"order_weight": 0.7},
    "all": {"noise_weight": 0.3, "order_weight": 2.0},
}


@pytest.mark.parametrize("mode", sorted(MSE_MODES))
@pytest.mark.parametrize("k", [2, 3])
def test_mse_matches(mode, k):
    masks, batch = _mask_batch(10 + k, k=k, sources_far=mode != "order_close")
    kw = MSE_MODES[mode]
    lw, gw, aw = _value_and_grad_jax(JMse(**kw), masks, batch, k)
    lt, gt, at = _value_and_grad_torch(MeanSquaredError(**kw), masks, batch,
                                       k)
    np.testing.assert_allclose(lt, lw, rtol=1e-5)
    np.testing.assert_allclose(gt, gw, atol=1e-5 * np.abs(gw).max())
    np.testing.assert_array_equal(at["perms"].numpy(),
                                  np.asarray(aw["perms"]))
    assert set(at) == set(aw)
    for key in aw:
        if key != "perms":
            np.testing.assert_allclose(float(at[key].detach()),
                                       float(aw[key]),
                                       rtol=1e-5, atol=1e-7)


def test_mse_consistency_pair_matches():
    """Masks of 2B rows (the trainer's two crops): the shared frames'
    disagreement plus PIT on the first crop."""
    masks, batch = _mask_batch(20)
    masks = np.concatenate([masks, masks[:, ::-1] * 0.9])
    batch["input"] = np.concatenate([batch["input"], batch["input"]])
    kw = {"consistency_weight": 0.5, "consistency_frames": 5,
          "noise_weight": 0.3}
    lw, gw, aw = _value_and_grad_jax(JMse(**kw), masks, batch, 2)
    lt, gt, at = _value_and_grad_torch(MeanSquaredError(**kw), masks, batch,
                                       2)
    np.testing.assert_allclose(lt, lw, rtol=1e-5)
    np.testing.assert_allclose(gt, gw, atol=1e-5 * np.abs(gw).max())
    np.testing.assert_allclose(float(at["consistency"]),
                               float(aw["consistency"]), rtol=1e-5)


@pytest.mark.parametrize("k", [2, 3])
def test_snr_matches(k):
    rng = _rng(30 + k)
    src = rng.standard_normal((3, k, 1600)).astype(np.float32)
    est = (src[:, ::-1] + 0.5 * rng.standard_normal(src.shape)
           ).astype(np.float32)[..., :1590]
    batch = {f"source{i + 1}": src[:, i] for i in range(k)}

    def jf(e):
        return JSnr()(e, {kk: jnp.asarray(v) for kk, v in batch.items()})

    (lw, aw), gw = jax.value_and_grad(jf, has_aux=True)(jnp.asarray(est))
    e = torch.as_tensor(est.copy()).requires_grad_(True)
    lt, at = SiSnrObjective()(e, {kk: torch.as_tensor(v)
                                  for kk, v in batch.items()})
    lt.backward()
    np.testing.assert_allclose(float(lt.detach()), float(lw), rtol=1e-5)
    gw = np.asarray(gw)
    np.testing.assert_allclose(e.grad.numpy(), gw,
                               atol=1e-5 * np.abs(gw).max())
    np.testing.assert_array_equal(at["perms"].numpy(), np.asarray(aw["perms"]))


@pytest.mark.parametrize("mag_weight", [0.0, 0.5])
def test_masksnr_matches(mag_weight):
    rng = _rng(40)
    n, k = 4096, 2
    src = (0.1 * rng.standard_normal((3, k, n))).astype(np.float32)
    src[0, 1] *= 1e-4  # a near-silent speaker: the clamp binds
    mix = src.sum(1) + 0.01 * rng.standard_normal((3, n)).astype(np.float32)
    t = (n - 512) // 256 + 1
    masks = rng.uniform(0, 1, (3, t, 257, k + 1)).astype(np.float32)
    batch = {"mix_wav": mix, **{f"source{i + 1}": src[:, i]
                                for i in range(k)}}
    jobj, tobj = (JMaskSnr(mag_weight=mag_weight),
                  MaskSiSnr(mag_weight=mag_weight))

    def jf(m):
        return jobj((None, m), {kk: jnp.asarray(v) for kk, v in batch.items()})

    (lw, aw), gw = jax.value_and_grad(jf, has_aux=True)(jnp.asarray(masks))
    m = torch.as_tensor(masks).requires_grad_(True)
    lt, at = tobj((None, m), {kk: torch.as_tensor(v)
                              for kk, v in batch.items()})
    lt.backward()
    np.testing.assert_allclose(float(lt.detach()), float(lw), rtol=1e-4)
    gw = np.asarray(gw)
    np.testing.assert_allclose(m.grad.numpy(), gw,
                               atol=1e-4 * np.abs(gw).max())
    np.testing.assert_array_equal(at["perms"].numpy(), np.asarray(aw["perms"]))
    assert set(at) == set(aw)


def test_objective_registry_and_flags():
    import argparse

    assert sorted(OBJECTIVES) == ["MSE", "MaskSNR", "SNR"]
    parser = argparse.ArgumentParser()
    for cls in OBJECTIVES.values():
        cls.add_args(parser)
    conf = vars(parser.parse_args(["--mse-noise-weight", "0.3",
                                   "--mse-order-weight", "0.5",
                                   "--masksnr-clamp-db", "20"]))
    mse = build_objective("MSE", conf)
    assert (mse.noise_weight, mse.order_weight, mse.consistency_frames) == (
        0.3, 0.5, 25)
    assert build_objective("MaskSNR", conf).clamp_db == 20.0
    assert isinstance(build_objective("SNR", conf), SiSnrObjective)


@pytest.mark.parametrize("conf", [
    dict(lr=1e-4, warmup=20, decay=1e-2),
    dict(lr=1e-3, warmup=0, fixed=10, decay=0.05),
    dict(lr=3e-4, warmup=7, fixed=5, decay=0.1, min_lr=1e-6),
    dict(lr=1e-4, warmup=20000, decay=1e-5),
    dict(lr=2e-3),
], ids=["warmup", "fixed", "all", "recipe", "flat"])
def test_lr_schedule_matches(conf):
    j, t = JSchedule(**conf), LRSchedule(**conf)
    want = np.array([float(j(s)) for s in range(51)])
    got = np.array([t(s) for s in range(51)])
    np.testing.assert_allclose(got, want, rtol=1e-6)
    if conf.get("warmup"):
        assert got[0] == np.float32(conf.get("min_lr", 1e-9))
