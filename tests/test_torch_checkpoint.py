"""The port's npz checkpoint reader against css_tpu.trainer.checkpoint."""

import io
import json

import numpy as np
import pytest

from css_tpu.trainer.checkpoint import load_checkpoint as jax_load
from css_tpu_torch.trainer.checkpoint import load_checkpoint

FLAGSHIP = "checkpoints/h2ft_masksnr_best.mdl"


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def test_reader_matches_reference_on_flagship():
    got = load_checkpoint(FLAGSHIP)
    want = jax_load(FLAGSHIP)
    assert got["conf"] == want["conf"]
    assert got["conf"]["bf16"] is True
    for section in ("params", "batch_stats"):
        g, w = _flat(got[section]), _flat(want[section])
        assert set(g) == set(w)
        for k in w:
            assert w[k].dtype == np.float16  # the slim f16 archive
            assert g[k].dtype == np.float32
            np.testing.assert_array_equal(g[k], w[k].astype(np.float32))
    assert len(_flat(got["params"])) + len(_flat(got["batch_stats"])) == 583


def _write_npz(path, arrays, meta):
    arrays = dict(arrays)
    arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    path.write_bytes(buf.getvalue())


def test_reader_keeps_float32_and_opt_state(tmp_path):
    p = tmp_path / "c.mdl"
    _write_npz(p, {"params/a/kernel": np.ones((2, 3), np.float32),
                   "batch_stats/a/mean": np.zeros(3, np.float16),
                   "opt_state/00001": np.arange(3.0),
                   "opt_state/00000": np.zeros(2)},
               {"format": 1, "epoch": 3, "conf": {"x": 1}, "dtypes": {}})
    ck = load_checkpoint(p)
    assert ck["epoch"] == 3 and ck["conf"] == {"x": 1}
    assert ck["params"]["a"]["kernel"].dtype == np.float32
    assert ck["batch_stats"]["a"]["mean"].dtype == np.float32
    assert [o.shape for o in ck["opt_state"]] == [(2,), (3,)]


def test_reader_refuses_ml_dtypes_and_pickles(tmp_path):
    p = tmp_path / "bf16.mdl"
    _write_npz(p, {"params/w": np.zeros(4, np.uint16)},
               {"format": 1, "dtypes": {"params/w": "bfloat16"}})
    with pytest.raises(ValueError, match="ml_dtypes"):
        load_checkpoint(p)
    q = tmp_path / "legacy.mdl"
    q.write_bytes(b"\x80\x04legacy pickle")
    with pytest.raises(ValueError, match="not an npz"):
        load_checkpoint(q)
