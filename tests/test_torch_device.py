"""Entry points run on the card unless asked for the CPU, and never fall
back to it on their own; the kernel build says clearly when nvcc is
missing."""

import pytest
import torch

from css_tpu_torch import device as dev_mod
from css_tpu_torch.executor.beamformer import Beamformer
from css_tpu_torch.executor.pipeline import CssPipeline
from css_tpu_torch.executor.separator import Separator
from css_tpu_torch.executor.stitcher import Stitcher
from css_tpu_torch.ops import _build


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_resolve_device(no_card):
    assert dev_mod.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dev_mod.resolve_device("cuda")
    with pytest.raises(RuntimeError):
        dev_mod.resolve_device("cuda:0")
    with pytest.raises(ValueError, match="unsupported device"):
        dev_mod.resolve_device("meta")


@pytest.mark.parametrize("make", [
    lambda **kw: Separator(torch.nn.Identity(), **kw),
    lambda **kw: Stitcher(**kw),
    lambda **kw: Beamformer("masking", **kw),
    lambda **kw: CssPipeline(torch.nn.Identity(),
                             {"beamforming": {"type": "masking"}}, **kw),
], ids=["Separator", "Stitcher", "Beamformer", "CssPipeline"])
def test_entry_points_default_to_cuda_and_raise_without_a_card(no_card, make):
    with pytest.raises(RuntimeError, match="cuda"):
        make()
    assert make(device="cpu").device == torch.device("cpu")


def test_cli_raises_without_a_card(no_card, tmp_path):
    from css_tpu_torch.cli import separate

    with pytest.raises(RuntimeError, match="cuda"):
        separate.main(["--config", "configs/infer_1ch.yaml", "--checkpoint",
                       "checkpoints/h2ft_masksnr_best.mdl", "--corpus-dir",
                       str(tmp_path), "--out-dir", str(tmp_path / "out")])


def test_build_names_the_missing_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build, "DEFAULT_NVCC", str(tmp_path / "nvcc"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
    assert not (tmp_path / "build").exists()


def test_library_name_follows_the_sources():
    path = _build.library_path()
    assert path.parent == _build.BUILD_DIR
    assert path.parent.name == "_build" and path.parent.parent.name == (
        "css_tpu_torch")
    assert path.name.startswith("libcss_kernels_") and path.suffix == ".so"
    assert sorted(p.name for p in _build.CSRC.glob("*.cu")) == [
        "add_layer_norm.cu", "conv_module.cu", "istft.cu", "lstm.cu",
        "stft_mag.cu"]
