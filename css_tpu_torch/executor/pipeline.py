"""End-to-end continuous separation pipeline (1ch and 7ch).

Port of ``css_tpu/executor/pipeline.py``: separator -> stitcher ->
beamformer per recording, then optionally stream re-anchoring on the
host, configured from the reference YAML schema ({separation, stitching,
beamforming}, ``configs/infer_1ch.yaml`` and ``configs/infer_7ch.yaml``)
with the reference's defaults (a config without ``beamforming.type``
runs Souden MVDR). The recording goes to ``device`` once; the separated
streams come back to the host as numpy. ``separation.sharded: true``
splits the windows of a recording over ``shard_devices`` (default: every
visible card; ``executor/sharded.py``), stitches them on the first, and
resynthesises there as the default path does.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from css_tpu_torch.data.wav_io import write_wav
from css_tpu_torch.device import resolve_device
from css_tpu_torch.executor.beamformer import Beamformer
from css_tpu_torch.executor.reanchor import reanchor_streams
from css_tpu_torch.executor.separator import Separator
from css_tpu_torch.executor.sharded import ShardedSeparation
from css_tpu_torch.executor.stitcher import Stitcher
from css_tpu_torch.executor.windowing import pad_for_windows


class CssPipeline:
    def __init__(self, model: torch.nn.Module, config: Dict, sr: int = 16000,
                 device: Union[str, torch.device] = "cuda",
                 shard_devices: Optional[Sequence] = None):
        """``model`` is moved to ``device`` and put in eval mode;
        ``shard_devices`` are sharded separation's (its first should be
        ``device``)."""
        self.device = resolve_device(device)
        sep = config.get("separation", {})
        sti = config.get("stitching", {})
        bf = config.get("beamforming", {})
        self.sr = int(config.get("sampling_rate", sr))
        self.num_spk = int(sep.get("num_spk", getattr(model, "num_spk", 2)))
        self.model = model.to(self.device).eval()
        self.separator = Separator(
            self.model, sr=self.sr,
            eval_win=float(sep.get("eval_win", 2.4)),
            eval_hop=float(sep.get("eval_hop", 0.8)),
            frame_len=int(sep.get("frame_length", 512)),
            frame_hop=int(sep.get("frame_shift", 256)),
            batch_size=int(sep.get("batch_size", 32)),
            ipd_index=sep.get("ipd"),
            merge=bool(sep.get("merge", False)),
            merge_threshold=float(sep.get("merge_threshold", 16.0)),
            num_spk=self.num_spk,
            device=self.device,
        )
        self.stitcher = Stitcher(
            eval_win=float(sti.get("eval_win", sep.get("eval_win", 2.4))),
            eval_hop=float(sti.get("eval_hop", sep.get("eval_hop", 0.8))),
            fft_hop=int(sti.get("hop_size", sep.get("frame_shift", 256))),
            sr=self.sr,
            wta_floor=float(bf.get("wta_thresh", 1e-4)),
            num_spk=self.num_spk,
            device=self.device,
        )
        self.sharded = None
        if sep.get("sharded"):
            self.sharded = ShardedSeparation(
                self.model,
                shard_devices if shard_devices is not None else (
                    None if self.device.type == "cuda" else [self.device]),
                sr=self.sr, eval_win=float(sep.get("eval_win", 2.4)),
                eval_hop=float(sep.get("eval_hop", 0.8)),
                frame_len=int(sep.get("frame_length", 512)),
                frame_hop=int(sep.get("frame_shift", 256)),
                ipd_index=sep.get("ipd"),
                wta_floor=float(bf.get("wta_thresh", 1e-4)),
                num_spk=self.num_spk,
                batch_size=int(sep.get("batch_size", 32)))
        # session-level stream-identity re-anchoring on the host streams
        # (executor/reanchor.py)
        self.reanchor = bool(sti.get("reanchor", False))
        self.beamformer = Beamformer(
            bf_type=bf.get("type", "souden_mvdr"),
            sr=self.sr,
            n_fft=int(bf.get("n_fft", 512)),
            hop_length=int(bf.get("hop_size", 256)),
            eval_win=float(bf.get("eval_win", 2.4)),
            eval_hop=float(bf.get("eval_hop", 0.8)),
            proceed_margin=float(bf.get("proceed_margin", 2.0)),
            device=self.device,
        )
        # only these read channels other than channel 0
        self.reads_all_channels = bool(
            sep.get("ipd") or self.separator.merge
            or self.beamformer.bf_type == "souden_mvdr")

    @torch.no_grad()
    def process(self, wav: np.ndarray) -> Tuple[np.ndarray, ...]:
        """wav (T,) or (C, T) -> tuple of num_spk separated streams (T,),
        float32. Only the IPD features, the DOA merge and Souden MVDR read
        channels other than channel 0, so a (C, T) recording keeps all of
        them when the config asks for one of those, and goes on as channel
        0 alone otherwise, which gives the reference's streams."""
        wav = np.asarray(wav, np.float32)
        if wav.ndim == 2 and not self.reads_all_channels:
            wav = wav[0]
        if wav.ndim not in (1, 2):
            raise ValueError(f"a recording is (T,) or (C, T), got "
                             f"{wav.shape}")
        wav = torch.as_tensor(wav, device=self.device)
        total = wav.shape[-1]
        wav = pad_for_windows(wav, self.separator.win, self.separator.hop)
        if self.sharded is not None:
            stitched = [s.to(self.device)
                        for s in self.sharded.separate(wav)[0]]
        else:
            masks, mags = self.separator.separate(wav)
            stitched = self.stitcher(masks, mags)
        outs = self.beamformer.continuous_process(wav, stitched)
        outs = [o[:total].cpu().numpy() for o in outs]
        if self.reanchor:
            outs, _ = reanchor_streams(outs, sr=self.sr)
        return tuple(outs)

    def process_recording(self, key: str, wav: np.ndarray, out_dir: str):
        """Separate one recording and write {key}_{i}.wav per stream."""
        outs = self.process(wav)
        out_dir = Path(out_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        for i, out in enumerate(outs):
            write_wav(out_dir / f"{key}_{i}.wav", out, self.sr)
        return outs


def write_streams(key: str, streams: np.ndarray, out_dir, sr: int,
                  peak: float = 0.9):
    """Write {key}_{i}.wav per stream of (K, T) ``streams``, each
    peak-normalised to ``peak``: the streaming pipelines cannot normalise
    as they go (a causal system never knows the global peak), so their
    CLI does it at write time, with the offline path's naming and peak."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    for i, o in enumerate(np.asarray(streams)):
        write_wav(out_dir / f"{key}_{i}.wav",
                  o * peak / max(np.abs(o).max(), 1e-12), sr)
