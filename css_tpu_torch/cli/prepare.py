"""Manifest preparation (port of ``css_tpu/cli/prepare.py``): walks a tree
of wav files and writes the jsonl manifests the other CLIs read.

Three modes:
  utterances  -> training manifest {utt_id, speaker, duration, path}; the
                 speaker is a path component or the filename's prefix
                 (LibriSpeech layout: .../<speaker>/<chapter>/<utt>.wav)
  recordings  -> separation manifest {utt_id, path} for cli.separate (any
                 wav tree; keys from the relative path)
  libricss    -> separation manifest from the LibriCSS release layout
                 (for_release/{0L,0S,OV10..OV40}/overlap_ratio_..._sessionN_
                 .../record/raw_recording.wav), keyed "sessionN_COND";
                 --transcripts-output also writes {key, texts: [...]} jsonl
                 from each session's transcription/meeting_info.txt for
                 cli.wer

    python -m css_tpu_torch.cli.prepare libricss --corpus-dir for_release \\
        --output recordings.jsonl --transcripts-output refs.jsonl
"""

from __future__ import annotations

import argparse
import json
import re
import wave
from pathlib import Path

from css_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)


def wav_duration(path: Path) -> float:
    with wave.open(str(path), "rb") as w:
        return w.getnframes() / w.getframerate()


def meeting_texts(info: Path) -> list:
    """The transcriptions of a LibriCSS ``meeting_info.txt`` (the fifth
    tab-separated column, header row skipped), or [] without the file."""
    texts = []
    if info.exists():
        for i, line in enumerate(info.read_text().splitlines()):
            if i == 0 and line.lower().startswith("start"):
                continue  # header row
            cols = line.split("\t")
            if len(cols) >= 5 and cols[4].strip():
                texts.append(cols[4].strip())
    return texts


def prepare_libricss(corpus: Path, output: str,
                     transcripts_output=None) -> int:
    """LibriCSS release layout -> separation manifest (and the WER
    references); returns the session count. Keys are "session{N}_{COND}",
    COND the overlap condition's directory."""
    n = 0
    trans_fh = open(transcripts_output, "w") if transcripts_output else None
    with open(output, "w") as out:
        for wav_path in sorted(corpus.rglob("record/raw_recording.wav")):
            session_dir = wav_path.parent.parent
            cond = session_dir.parent.name  # 0L / 0S / OV10 ... OV40
            m = re.search(r"session(\d+)", session_dir.name)
            key = (f"session{m.group(1)}_{cond}" if m
                   else f"{cond}_{session_dir.name}")
            out.write(json.dumps({"utt_id": key, "path": str(wav_path)})
                      + "\n")
            n += 1
            if trans_fh is not None:
                texts = meeting_texts(
                    session_dir / "transcription" / "meeting_info.txt")
                trans_fh.write(json.dumps({"key": key, "texts": texts})
                               + "\n")
    if trans_fh is not None:
        trans_fh.close()
    return n


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("mode", choices=["utterances", "recordings",
                                         "libricss"])
    parser.add_argument("--corpus-dir", required=True)
    parser.add_argument("--output", required=True)
    parser.add_argument("--speaker-component", type=int, default=0,
                        help="path component index (relative to corpus dir) "
                             "holding the speaker id; -1 = filename prefix "
                             "before the first '-' (LibriSpeech style)")
    parser.add_argument("--transcripts-output", default=None,
                        help="libricss mode: also write {key, texts} jsonl "
                             "WER references from meeting_info.txt")
    args = parser.parse_args(argv)

    corpus = Path(args.corpus_dir)
    if args.mode == "libricss":
        n = prepare_libricss(corpus, args.output, args.transcripts_output)
        log.info("Wrote %d LibriCSS sessions to %s", n, args.output)
        return
    n = 0
    with open(args.output, "w") as out:
        for wav_path in sorted(corpus.rglob("*.wav")):
            rel = wav_path.relative_to(corpus)
            utt_id = str(rel.with_suffix("")).replace("/", "_")
            if args.mode == "recordings":
                rec = {"utt_id": utt_id, "path": str(wav_path)}
            else:
                if args.speaker_component == -1:
                    speaker = wav_path.stem.split("-")[0]
                else:
                    speaker = rel.parts[args.speaker_component]
                rec = {"utt_id": utt_id, "speaker": speaker,
                       "duration": round(wav_duration(wav_path), 3),
                       "path": str(wav_path)}
            out.write(json.dumps(rec) + "\n")
            n += 1
    log.info("Wrote %d entries to %s", n, args.output)


if __name__ == "__main__":
    main()
