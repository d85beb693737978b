"""A time-domain model (Conv-TasNet) in the port's user surfaces: the
paths built on K3 features and masks refuse it with a ``ValueError`` that
names the cause, and ``cli.separate --model ConvTasNet`` separates a
recording with a checkpoint that ``cli.train`` wrote."""

import numpy as np
import pytest
import torch

from css_tpu_torch.cli import export
from css_tpu_torch.data.wav_io import read_wav, write_wav
from css_tpu_torch.executor.hop_streaming import HopStreamingPipeline
from css_tpu_torch.executor.pipeline import CssPipeline
from css_tpu_torch.executor.separator import Separator
from css_tpu_torch.executor.streaming import StreamingCssPipeline
from css_tpu_torch.models.conv_tasnet import ConvTasNet

SR = 16000
TINY = ["--conv-tasnet-num-filters", "16", "--conv-tasnet-filter-length",
        "16", "--conv-tasnet-bottleneck-channels", "8",
        "--conv-tasnet-conv-channels", "16", "--conv-tasnet-num-blocks",
        "2", "--conv-tasnet-num-layers", "1"]


def _model():
    return ConvTasNet(num_filters=16, bottleneck_channels=8, conv_channels=16,
                      num_blocks=2, num_layers=1)


REFUSED = {
    "sharded separation": lambda m: CssPipeline(
        m, {"separation": {"sharded": True}}, device="cpu"),
    "window streaming": lambda m: StreamingCssPipeline(m, {}, device="cpu"),
    "hop streaming": lambda m: HopStreamingPipeline(m, {}, device="cpu"),
    "the exported forward": lambda m: export.export_forward(
        m, 2, 150, 257, device="cpu"),
    "the DOA merge": lambda m: Separator(m, merge=True, device="cpu"),
}


@pytest.mark.parametrize("where", sorted(REFUSED))
def test_a_time_domain_model_is_refused_where_masks_are_needed(where):
    with pytest.raises(ValueError, match="time domain") as err:
        REFUSED[where](_model())
    assert where in str(err.value)


def test_separate_cli_runs_a_conv_tasnet_that_cli_train_wrote(tmp_path):
    """Two steps of cli.train --model ConvTasNet at tiny widths, then
    cli.separate --model ConvTasNet on a 5 s recording under the 1-channel
    config: one wav a speaker, the recording's length, peak 0.9."""
    from css_tpu_torch.cli import separate
    from css_tpu_torch.cli import train as ttrain

    exp = tmp_path / "exp"
    ttrain.main(["--model", "ConvTasNet", "--synthetic-data",
                 "--synthetic-speakers", "4", "--synthetic-utts", "2",
                 "--batch-size", "2", "--batches-per-epoch", "2",
                 "--num-epochs", "1", "--optim", "adam", "--lr", "1e-3",
                 "--min-window-size", "1.0", "--max-window-size", "1.0",
                 "--validate-batches", "1", "--num-workers", "1",
                 "--expdir", str(exp), "--device", "cpu"] + TINY)
    recs = tmp_path / "recs"
    recs.mkdir()
    rng = np.random.default_rng(7)
    wav = (0.1 * rng.standard_normal(5 * SR)).astype(np.float32)
    write_wav(recs / "sess.wav", wav)
    out = tmp_path / "out"
    separate.main(["--config", "configs/infer_1ch.yaml", "--checkpoint",
                   str(exp / "1.1.mdl"), "--model", "ConvTasNet",
                   "--corpus-dir", str(recs), "--out-dir", str(out),
                   "--device", "cpu"])
    assert sorted(p.name for p in out.iterdir()) == ["sess_0.wav",
                                                     "sess_1.wav"]
    for name in ("sess_0.wav", "sess_1.wav"):
        got, sr = read_wav(out / name)
        assert sr == SR and got.shape == wav.shape
        assert np.isfinite(got).all()
        assert np.abs(got).max() == pytest.approx(0.9, abs=2.0 / 32767)
    model = separate.load_model(str(exp / "1.1.mdl"), "ConvTasNet")
    assert model.domain == "time" and model.num_filters == 16
    assert torch.isfinite(model(torch.as_tensor(wav[:16000]))).all()
