"""Models: the Conformer and BLSTM mask estimators and the Conv-TasNet
time-domain separator. Each model brings its converters from and to the
JAX package's checkpoint layout."""

from typing import Dict, Tuple

import numpy as np
import torch

from css_tpu_torch.models import blstm, conformer, conv_tasnet

MODELS = {"Conformer": conformer.Conformer, "BLSTM": blstm.BLSTM,
          "ConvTasNet": conv_tasnet.ConvTasNet}
CONVERTERS = {
    "Conformer": lambda ckpt: conformer.params_from_jax(
        ckpt["params"], ckpt.get("batch_stats")),
    "BLSTM": lambda ckpt: blstm.params_from_jax(ckpt["params"]),
    "ConvTasNet": lambda ckpt: conv_tasnet.params_from_jax(ckpt["params"]),
}


def build_model(name: str, conf: dict):
    if name not in MODELS:
        raise KeyError(f"model {name!r} is not ported; available: "
                       f"{sorted(MODELS)}")
    return MODELS[name].build_model(conf)


def state_dict_from_checkpoint(name: str,
                               ckpt: Dict) -> Dict[str, torch.Tensor]:
    """A loaded ``.mdl`` checkpoint -> the ``name`` model's state_dict."""
    return CONVERTERS[name](ckpt)


def _jax_path(key: str) -> list:
    """A state_dict key -> its path in the JAX package's layout, before the
    leaf renaming: ``encoders.i`` becomes ``encoders_i``."""
    parts, path = key.split("."), []
    i = 0
    while i < len(parts):
        if (parts[i] == "encoders" and i + 1 < len(parts)
                and parts[i + 1].isdigit()):
            path.append(f"encoders_{parts[i + 1]}")
            i += 2
        else:
            path.append(parts[i])
            i += 1
    return path


def _set_path(tree: dict, path, value) -> None:
    for p in path[:-1]:
        tree = tree.setdefault(p, {})
    tree[path[-1]] = value


def to_jax(state_dict: Dict[str, torch.Tensor]) -> Tuple[Dict, Dict]:
    """The inverse of the models' ``params_from_jax``, one rule for all: a
    state_dict (or any dict of tensors keyed like one, such as Adam's
    moments by parameter name) -> the JAX package's nested float32 numpy
    (params, batch_stats). 2-D weights become (in, out) ``kernel``s, 1-D
    weights ``scale``s, the Conformer's depthwise conv weight (C, 1, K)
    its ``dw_kernel`` (K, 1, C), and running statistics ``mean``/``var``
    in batch_stats; every other name and layout is kept."""
    params: Dict = {}
    stats: Dict = {}
    for key, t in state_dict.items():
        a = t.detach().float().cpu().numpy().copy()  # never a view of t
        path = _jax_path(key)
        tree = params
        if path[-1] in ("running_mean", "running_var"):
            tree, path[-1] = stats, path[-1][len("running_"):]
        elif path[-2:] == ["dw_conv", "weight"]:
            path[-2:], a = ["dw_kernel"], a.transpose(2, 1, 0)
        elif path[-2:] == ["dw_conv", "bias"]:
            path[-2:] = ["dw_bias"]
        elif path[-1] == "weight":
            if a.ndim == 2:
                path[-1], a = "kernel", a.T
            else:
                path[-1] = "scale"
        _set_path(tree, path, np.ascontiguousarray(a))
    return params, stats


def from_jax(model, params: Dict, batch_stats: Dict = None,
             replica: int = None, tp_shard: Tuple[int, int] = None
             ) -> Dict[str, torch.Tensor]:
    """Nested JAX-layout (params, batch_stats) -> ``model``'s state_dict,
    through the converter of the model's class. ``replica=j`` takes
    replica j of a stacked replica tree (the JAX package's
    ``ReplicaAveraging`` state: a leading replica axis on every leaf);
    ``tp_shard=(index, parts)`` returns tensor-parallel shard ``index`` of
    ``parts`` (``parallel.mesh.shard_params`` under ``conformer_tp_spec``;
    ``parallel.mesh.gather_params`` is the way back)."""
    if replica is not None:
        def pick(tree):
            return {k: (pick(v) if isinstance(v, dict)
                        else np.asarray(v)[replica]) for k, v in tree.items()}

        params, batch_stats = pick(params), pick(batch_stats or {})
    name = next(n for n, cls in MODELS.items() if isinstance(model, cls))
    sd = CONVERTERS[name]({"params": params, "batch_stats": batch_stats})
    if tp_shard is not None:
        from css_tpu_torch.parallel.mesh import conformer_tp_spec, shard_params

        sd = shard_params(sd, conformer_tp_spec(sd), *tp_shard)
    return sd


def init_variables(model, seed: int) -> Tuple[Dict, Dict]:
    """Random (params, batch_stats) for ``model`` from a numpy seed, in the
    JAX package's layout and in its initialisers' families (not its bits):
    lecun-normal Dense, conv and LSTM input kernels, orthogonal LSTM
    recurrent kernels, normal(1) ``pe_k`` and GLU weights, 0.25 PReLU
    slopes, unit norm scales and output affine, zero biases; BatchNorm
    statistics mean 0, variance 1. Leaves are drawn in sorted path
    order."""
    params, stats = to_jax(model.state_dict())
    rng = np.random.default_rng(seed)

    def draw(path, a):
        leaf, shape = path[-1], np.shape(a)
        if leaf.endswith("kernel") or leaf.startswith("w_ih_"):
            return blstm._lecun_normal(rng, shape)
        if leaf.startswith("w_hh_"):
            return blstm._orthogonal(rng, shape)
        if leaf in ("pe_k", "pw1_w"):
            return rng.standard_normal(shape).astype(np.float32)
        if leaf in ("scale", "pw2_w"):
            return np.ones(shape, np.float32)
        if leaf.startswith("prelu"):
            return np.full(shape, 0.25, np.float32)
        return np.zeros(shape, np.float32)

    def walk(tree, path):
        return {k: (walk(tree[k], path + [k]) if isinstance(tree[k], dict)
                    else draw(path + [k], tree[k])) for k in sorted(tree)}

    return walk(params, []), _fresh_stats(stats)


def _fresh_stats(tree):
    return {k: (_fresh_stats(v) if isinstance(v, dict)
                else (np.ones_like(v) if k == "var" else np.zeros_like(v)))
            for k, v in tree.items()}
