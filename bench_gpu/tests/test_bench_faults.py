"""A run with its timed path broken underneath comes out not correct:
the harness's look for a card skipped, everything else as a run does it,
at a tiny size on the CPU, for each fault a cell can have (one card: no
exchange between chips to leave out)."""

import json

import numpy as np
import pytest

from bench_gpu import run
from bench_gpu.calibrate import FAULTS
from bench_gpu.harness import manifest
from bench_gpu.tests.conftest import training_root


def _half_windows(pipe):
    """Half of each separator batch left out: every other window's masks
    taken as the mean of the others'."""
    forward = pipe.separator.forward

    def broken(batch):
        masks, mag, kill = forward(batch)
        masks = masks.clone()
        masks[1::2] = masks[0::2].mean(dim=0)
        return masks, mag, kill
    pipe.separator.forward = broken


def _swapped_answer(pipe):
    """An answer altered where it is produced: the streams swapped from a
    quarter of the recording on, as a stitching fault at one boundary."""
    process = pipe.process

    def broken(wav):
        a, b = process(wav)
        q = a.shape[0] // 4
        return (np.concatenate([a[:q], b[q:]]),
                np.concatenate([b[:q], a[q:]]))
    pipe.process = broken


def _unchanged(trainer):
    """A step that returns its state unchanged: no update applied."""
    schedule = trainer.schedule
    trainer.schedule = lambda n: 0.0 * schedule(n)


SEPARATION = {"half_windows": _half_windows,
              "swapped_answer": _swapped_answer}
TRAINING = {"unchanged": _unchanged, **FAULTS}
CASES = ([("conformer_css16x256.sep_libricss10min", "separation", f)
          for f in SEPARATION]
         + [("blstm_css1024x3.sep_libricss10min", "separation", f)
            for f in SEPARATION]
         + [(f"{c}.train_recipe_speed", "training", f)
            for c in ("conformer_css16x256", "blstm_css1024x3")
            for f in TRAINING])


@pytest.mark.parametrize("workload,kind,fault", CASES)
def test_fault_is_not_correct(workload, kind, fault, tiny, tmp_path):
    root = training_root(tmp_path) if kind == "training" else manifest.ROOT
    over = tiny[kind]
    plant = (SEPARATION if kind == "separation" else TRAINING)[fault]
    over["hooks"] = {"pipeline" if kind == "separation" else "trainer":
                     plant}
    rc, line, err = run.run_cell(workload, 11, 1.0, False, device="cpu",
                                 overrides=over, root=root)
    assert rc == 0, err
    out = json.loads(line)
    assert out["correct"] is False, out["checks"]
