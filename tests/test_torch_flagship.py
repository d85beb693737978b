"""Full width, one case: the committed flagship checkpoint (16 blocks x 256,
4 heads, kernel 33) in both packages, float32, on 2 windows of a numpy
mixture. Float32 with full-precision matmuls on both sides: the products
are summed in other orders through 16 blocks, so masks (of order 1) agree
to 2e-3 absolute (measured 3e-4)."""

import jax.numpy as jnp
import numpy as np
import torch

from css_tpu.models.conformer import Conformer as JaxConformer
from css_tpu.ops.features import FeatureExtractor as JaxFeatures
from css_tpu.trainer.checkpoint import load_checkpoint as jax_load
from css_tpu_torch.cli.separate import load_model
from css_tpu_torch.ops.features import FeatureExtractor

FLAGSHIP = "checkpoints/h2ft_masksnr_best.mdl"


def test_flagship_masks_match_float32():
    rng = np.random.default_rng(11)
    windows = (rng.standard_normal((2, 38656)) * 0.1).astype(np.float32)

    ck = jax_load(FLAGSHIP)
    conf = dict(ck["conf"], bf16=False)
    jm = JaxConformer.build_model(conf)
    _, feats = JaxFeatures()(jnp.asarray(windows))[:2]
    variables = {"params": ck["params"], "batch_stats": ck["batch_stats"]}
    _, want = jm.apply(variables, feats)

    model = load_model(FLAGSHIP)
    assert model.compute_dtype == torch.bfloat16  # the flagship's own conf
    model.compute_dtype = torch.float32
    _, tfeats = FeatureExtractor()(torch.as_tensor(windows))
    with torch.no_grad():
        _, got = model.eval()(tfeats)
    assert got.shape == (2, 150, 257, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-3)
