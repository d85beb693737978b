"""Checkpoints: the npz ``.mdl`` archive of the JAX package
(``css_tpu/trainer/checkpoint.py``), read and written with numpy alone.

The archive is a zip of ``.npy`` arrays -- ``params/<path>``,
``batch_stats/<path>``, ``opt_state/<i>`` -- plus a JSON ``__meta__``
record (``format``, ``dtypes``, step, epoch, loss, conf and extras).
Params and batch_stats are in the JAX package's layout (``models.to_jax``
makes them); ``opt_state`` holds the optax
chain's leaves in ``jax.tree.leaves`` order (``trainer.loop``), so a
checkpoint resumes in either package.

Reading: float16 arrays (the slim committed checkpoints) are cast to
float32; an array stored under the ``dtypes`` map (an extension dtype such
as bfloat16) raises, since the port does not depend on ``ml_dtypes``;
legacy pickle checkpoints are not read. Writing: numpy arrays as they are,
and a torch bfloat16 tensor as its raw bits with the ``dtypes`` map, which
the JAX package decodes. The port's trainer writes float32 and int32 only.

``average_checkpoints`` and ``gc_checkpoints`` are the JAX package's
post-epoch averaging (fraction-weighted over the surviving jobs, non-float
leaves from the last job) and epoch-checkpoint garbage collection.
"""

from __future__ import annotations

import io
import json
import os
import re
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch


@dataclass
class TrainState:
    """A trainer's state in the JAX package's layout, as numpy: the count
    of steps taken (non-finite ones too), params and batch_stats (nested
    dicts) and the optimiser's leaves."""
    step: int
    params: Dict
    batch_stats: Dict
    opt_state: List[np.ndarray]


def _flatten_dict(tree, prefix=""):
    """Nested dict of arrays -> {'a/b/c': array}."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten_dict(v, key + "/"))
        else:
            out[key] = v
    return out


def _unflatten_dict(flat: Dict[str, np.ndarray]) -> dict:
    out: dict = {}
    for key, v in flat.items():
        node = out
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


def tree_leaves(tree) -> list:
    """The leaves of nested dicts and lists in ``jax.tree.leaves`` order
    (dict keys sorted at every level)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_unflatten(like, leaves: list):
    """``leaves`` (in ``tree_leaves`` order) in the structure of ``like``."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return [build(v) for v in node]
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the structure holds")
    return out


def tree_map(fn: Callable, *trees):
    """fn over the corresponding leaves of same-structured trees."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (list, tuple)):
        return [tree_map(fn, *vs) for vs in zip(*trees)]
    return fn(*trees)


def _npz_encode(leaf, dtypes: Dict[str, str], key: str) -> np.ndarray:
    """numpy arrays as they are; a torch bfloat16 tensor as raw bits with
    its dtype recorded (numpy has no bfloat16)."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:
            dtypes[key] = "bfloat16"
            return leaf.view(torch.int16).numpy().view(np.uint16)
        return leaf.numpy()
    return np.asarray(leaf)


def save_checkpoint_dict(path: str, ckpt: Dict[str, Any]) -> None:
    """Write a checkpoint dict as an npz archive (atomic)."""
    arrays: Dict[str, np.ndarray] = {}
    dtypes: Dict[str, str] = {}
    meta: Dict[str, Any] = {"format": 1}
    for key, value in ckpt.items():
        if key in ("params", "batch_stats"):
            for p, leaf in _flatten_dict(value).items():
                k = f"{key}/{p}"
                arrays[k] = _npz_encode(leaf, dtypes, k)
        elif key == "opt_state":
            for i, leaf in enumerate(tree_leaves(value)):
                k = f"opt_state/{i:05d}"
                arrays[k] = _npz_encode(leaf, dtypes, k)
        else:  # scalars, conf, extras: JSON-serialisable
            meta[key] = value
    meta["dtypes"] = dtypes
    arrays["__meta__"] = np.frombuffer(
        json.dumps(meta, default=str).encode(), np.uint8)
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    tmp = str(path) + ".tmp"
    with open(tmp, "wb") as f:
        f.write(buf.getvalue())
    os.replace(tmp, path)


def save_checkpoint(path: str, state: TrainState, epoch: int, loss: float,
                    conf: Optional[dict] = None,
                    extra: Optional[dict] = None) -> None:
    ckpt = {
        "params": state.params,
        "batch_stats": state.batch_stats,
        "opt_state": state.opt_state,
        "step": int(state.step),
        "epoch": int(epoch),
        "loss": float(loss),
        "conf": conf or {},
    }
    if extra:
        ckpt.update(extra)
    save_checkpoint_dict(path, ckpt)


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


def restore_state(ckpt: Dict[str, Any], state: TrainState) -> TrainState:
    """A TrainState from a checkpoint, checked against ``state`` (the
    trainer's own): the same parameter paths and shapes, and as many
    optimiser leaves."""
    want = {k: np.shape(v) for k, v in _flatten_dict(state.params).items()}
    got = {k: np.shape(v) for k, v in _flatten_dict(ckpt["params"]).items()}
    if want != got:
        raise ValueError(
            f"checkpoint params differ from the model's: "
            f"{sorted(set(want) ^ set(got))[:4]} "
            f"{[k for k in want if k in got and want[k] != got[k]][:4]}")
    opt = tree_leaves(ckpt["opt_state"])
    if len(opt) != len(state.opt_state):
        raise ValueError(f"checkpoint has {len(opt)} optimiser leaves, the "
                         f"trainer's optimiser {len(state.opt_state)}")
    return TrainState(step=int(ckpt["step"]), params=ckpt["params"],
                      batch_stats=ckpt["batch_stats"],
                      opt_state=[np.asarray(x) for x in opt])


def warm_start(params: Dict, ckpt_params: Dict, replace_output: bool = False,
               output_patterns: Sequence[str] = ("linear", "xent_layer",
                                                 "final_affine")) -> Dict:
    """Fresh ``params`` with every leaf that the checkpoint has at the same
    path and shape copied in, cast to the fresh leaf's dtype; with
    ``replace_output``, leaves under an output-layer component stay fresh
    (``--init`` of the JAX package)."""

    def copy(node, src, path):
        if isinstance(node, dict):
            return {k: copy(v, src.get(k, {}) if isinstance(src, dict)
                            else {}, path + [k]) for k, v in node.items()}
        if replace_output and any(c in output_patterns for c in path):
            return node
        if (isinstance(src, np.ndarray)
                and np.shape(src) == np.shape(node)):
            return np.asarray(src, dtype=np.asarray(node).dtype)
        return node

    return copy(params, ckpt_params, [])


def average_checkpoints(paths: Sequence[str], device="cpu"
                        ) -> Dict[str, Any]:
    """Fraction-weighted average over the surviving job checkpoints (1/N
    over the N that exist), summed in float64 on ``device``, leaf by leaf
    in job order as the JAX package's numpy sums (bit-equal); non-float
    leaves and the scalars from the last job."""
    existing = [p for p in paths if Path(p).exists()]
    if not existing:
        raise FileNotFoundError(f"no checkpoints among {paths}")
    frac = 1.0 / len(existing)
    ckpts = [load_checkpoint(p) for p in existing]

    def avg(*leaves):
        first = leaves[0]
        if not (isinstance(first, np.ndarray)
                and np.issubdtype(first.dtype, np.floating)):
            return leaves[-1]
        out = torch.zeros(first.shape, dtype=torch.float64, device=device)
        for leaf in leaves:
            out += torch.as_tensor(leaf).to(device, torch.float64) * frac
        return out.to(getattr(torch, first.dtype.name)).cpu().numpy()

    merged = dict(ckpts[-1])
    for key in ("params", "batch_stats", "opt_state"):
        merged[key] = tree_map(avg, *[c[key] for c in ckpts])
    return merged


def gc_checkpoints(expdir: str, keep_every: int = 20, keep_last: int = 2,
                   job: Optional[int] = None) -> None:
    """Delete old epoch checkpoints, keeping every ``keep_every``-th and
    the last ``keep_last``; job=None works on ``{e}.mdl``, job=J on
    ``{e}.{J}.mdl``."""
    expdir = Path(expdir)
    suffix = f".{job}.mdl" if job is not None else ".mdl"
    pattern = re.compile(r"^(\d+)" + re.escape(suffix) + "$")
    epochs = sorted(int(m.group(1)) for p in expdir.iterdir()
                    if (m := pattern.match(p.name)))
    if not epochs:
        return
    keep = set(epochs[-keep_last:])
    keep.update(e for e in epochs if e % keep_every == 0)
    for e in epochs:
        if e not in keep:
            (expdir / f"{e}{suffix}").unlink()

