"""The port's config reader (``css_tpu_torch/utils/config.py``) against
PyYAML, and ``css_tpu_torch.cli.separate --config`` with PyYAML absent.

The card machine has no PyYAML, so the port reads its pipeline configs
with its own reader of the YAML subset they use. On that subset it must
give what ``yaml.safe_load`` gives, types included; outside it, it
raises and names the line.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import yaml

from css_tpu_torch.utils.config import load_config, loads

REPO = Path(__file__).resolve().parent.parent

SNIPPETS = {
    "numbers": "a: 1\nb: 2.5\nc: -3\nd: 1e-4\ne: 1.0e-4\nf: .5\ng: -.5\n"
               "h: +7\ni: 08\nj: 0\nk: 1_000\nl: 3.\nm: .inf\nn: -.inf\n",
    "bools_and_null": "x: True\ny: false\nz: null\nw: ~\nv:\nu: yes\n"
                      "t: Off\ns: NULL\n",
    "quotes": "s: 'it''s'  # a comment\nr: \"a\\\"b\\n\"\nq: 'True'\n"
              "p: \"0.5\"\no: ''\n",
    "plain_strings": "ipd: 1,0;2,0;3,0\ntype: SoudenMVDRBeamformer\n"
                     "path: exp/a b/c.mdl\nk: -abc\nj: a#b\n",
    "nesting_and_comments": "# head\nouter:\n  inner:\n    deep: 3   # tail\n"
                            "  k: v\n# between\nnext: 0\n\n   # indented\n"
                            "last:\n",
}

BAD = {
    "sequence": ("a:\n  - 1\n", 2),
    "flow_sequence": ("a: [1, 2]\n", 1),
    "flow_mapping": ("a: 1\nb: {c: 1}\n", 2),
    "anchor": ("a: &x 1\n", 1),
    "alias": ("a: 1\nb: *x\n", 2),
    "tab": ("a:\n\tb: 1\n", 2),
    "hex": ("a: 0x1f\n", 1),
    "octal": ("a: 010\n", 1),
    "block_scalar": ("a: |\n  x\n", 1),
    "document": ("---\na: 1\n", 1),
    "dedent": ("a:\n    b: 1\n  c: 2\n", 3),
    "overindent": ("a: 1\n  b: 2\n", 2),
    "tag": ("a: !!str 1\n", 1),
    "open_quote": ("a: 1\nb: 'x\n", 2),
    "nested_value": ("a: b: c\n", 1),
    "int_key": ("1: x\n", 1),
    "sexagesimal": ("a: 1:30\n", 1),
    "date": ("a: 2001-01-01\n", 1),
}


@pytest.mark.parametrize("name", ["infer_1ch.yaml", "infer_7ch.yaml"])
def test_committed_configs_read_as_pyyaml_reads_them(name):
    path = REPO / "configs" / name
    with open(path) as fh:
        want = yaml.safe_load(fh)
    got = load_config(path)
    assert got == want
    # and with the same types (True is not 1, 16 is not 16.0)
    assert repr(got) == repr(want)


@pytest.mark.parametrize("name", sorted(SNIPPETS))
def test_snippets_read_as_pyyaml_reads_them(name):
    text = SNIPPETS[name]
    assert repr(loads(text)) == repr(yaml.safe_load(text))


@pytest.mark.parametrize("name", sorted(BAD))
def test_syntax_outside_the_subset_raises_and_names_the_line(name):
    text, line = BAD[name]
    with pytest.raises(ValueError, match=f"cfg.yaml, line {line}:"):
        loads(text, "cfg.yaml")


def test_separate_cli_runs_without_pyyaml(tmp_path):
    """``python -m css_tpu_torch.cli.separate --config
    configs/infer_1ch.yaml`` on a tiny BLSTM checkpoint, in a process
    where ``import yaml`` fails: it runs to its end and writes both
    streams."""
    from css_tpu_torch.data.wav_io import write_wav
    from css_tpu_torch.models import blstm
    from css_tpu_torch.trainer.checkpoint import save_checkpoint_dict

    conf = {"blstm_hdim": 16, "blstm_num_layers": 1}
    ckpt = tmp_path / "tiny.mdl"
    save_checkpoint_dict(str(ckpt), {"params": blstm.init_params(3, conf),
                                     "conf": conf})
    recs = tmp_path / "recs"
    recs.mkdir()
    rng = np.random.default_rng(4)
    write_wav(recs / "rec.wav", rng.standard_normal(16000 * 3).astype(
        np.float32) * 0.1)
    code = ("import sys, runpy; sys.modules['yaml'] = None; "
            "runpy.run_module('css_tpu_torch.cli.separate', "
            "run_name='__main__')")
    res = subprocess.run(
        [sys.executable, "-c", code, "--config",
         str(REPO / "configs" / "infer_1ch.yaml"), "--checkpoint", str(ckpt),
         "--model", "BLSTM", "--corpus-dir", str(recs), "--out-dir",
         str(tmp_path / "out"), "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert res.returncode == 0, res.stderr[-3000:]
    assert sorted(p.name for p in (tmp_path / "out").iterdir()) == [
        "rec_0.wav", "rec_1.wav"]
