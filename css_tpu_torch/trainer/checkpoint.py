"""Reader for the npz ``.mdl`` checkpoint archive (numpy only).

The archive (written by ``css_tpu.trainer.checkpoint.save_checkpoint_dict``)
is a zip of ``.npy`` arrays — ``params/<path>``, ``batch_stats/<path>``,
``opt_state/<i>`` — plus a JSON ``__meta__`` record whose ``dtypes`` map
names the arrays stored as raw bits of an extension dtype (bfloat16).

The port reads it with numpy alone: float16 arrays (the slim committed
checkpoints) are cast to float32 on load; an array whose dtype needs
``ml_dtypes`` raises, since the port does not depend on it. Legacy
pickle checkpoints are not read. Saving waits for the trainer slice.
"""

from __future__ import annotations

import json
from typing import Any, Dict

import numpy as np


def _unflatten_dict(flat: Dict[str, np.ndarray]) -> dict:
    out: dict = {}
    for key, v in flat.items():
        node = out
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


def load_checkpoint(path: str) -> Dict[str, Any]:
    """Load an npz checkpoint.

    Returns {params: nested dict, batch_stats: nested dict, opt_state:
    [leaves...], and the ``__meta__`` fields (conf, epoch, ...)}, with
    every float16 array cast to float32.
    """
    with open(path, "rb") as f:
        magic = f.read(2)
    if magic != b"PK":
        raise ValueError(
            f"{path}: not an npz checkpoint archive (legacy pickle "
            "checkpoints are read by the css_tpu package only)")
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        dtypes = meta.pop("dtypes", {})
        meta.pop("format", None)
        if dtypes:
            raise ValueError(
                f"{path}: arrays {sorted(dtypes)[:3]}... are stored as "
                f"{sorted(set(dtypes.values()))}, which needs ml_dtypes; "
                "re-save the checkpoint in float16 or float32")
        ckpt: Dict[str, Any] = dict(meta)
        sections: Dict[str, Dict[str, np.ndarray]] = {"params": {},
                                                      "batch_stats": {}}
        opt: Dict[str, np.ndarray] = {}
        for key in z.files:
            if key == "__meta__":
                continue
            section, _, rest = key.partition("/")
            arr = z[key]
            if arr.dtype == np.float16:
                arr = arr.astype(np.float32)
            if section in sections:
                sections[section][rest] = arr
            elif section == "opt_state":
                opt[rest] = arr
        ckpt["params"] = _unflatten_dict(sections["params"])
        ckpt["batch_stats"] = _unflatten_dict(sections["batch_stats"])
        ckpt["opt_state"] = [opt[k] for k in sorted(opt)]
    return ckpt
