"""css_tpu_torch.ops.features (mvn, 1ch FeatureExtractor) against css_tpu.

Float32; the same products summed in another order: 1e-4 absolute and
relative on MVN'd features of order 1.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from css_tpu.ops import features as jf
from css_tpu_torch.ops import features as tf

ATOL = RTOL = 1e-4


def test_epsilon_is_float32_eps():
    assert tf.EPSILON == jf.EPSILON


@pytest.mark.parametrize("dim", [-2, -1])
def test_mvn_matches(dim):
    x = np.random.default_rng(0).gamma(2.0, 1.0, (3, 50, 20)).astype(
        np.float32)
    got = tf.mvn(torch.as_tensor(x), dim=dim).numpy()
    want = np.asarray(jf.mvn(jnp.asarray(x), axis=dim))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    # Bessel-corrected: unit sample std with ddof=1
    np.testing.assert_allclose(got.std(axis=dim, ddof=1), 1.0, atol=1e-4)


def test_feature_extractor_1ch_matches():
    x = (np.random.default_rng(1).standard_normal((3, 38656)) * 0.1).astype(
        np.float32)
    x[2, :20000] = 0.0  # exact silence exercises the EPSILON floor
    mag_w, feat_w, _ = jf.FeatureExtractor(512, 256)(jnp.asarray(x))
    mag, feats = tf.FeatureExtractor(512, 256)(torch.as_tensor(x))
    assert mag.shape == feats.shape == (3, 150, 257)
    np.testing.assert_allclose(mag.numpy(), np.asarray(mag_w), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(feats.numpy(), np.asarray(feat_w), atol=ATOL,
                               rtol=RTOL)


def test_ipd_waits_for_the_7ch_slice():
    with pytest.raises(NotImplementedError, match="item 6"):
        tf.FeatureExtractor(ipd_index="1,0;2,0")
