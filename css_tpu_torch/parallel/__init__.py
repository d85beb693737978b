"""Parallel training: process groups and TP rules (``mesh``), the
strategies (``dp``) and the multi-process launcher (``launch``).

Exports what ``css_tpu.parallel`` exports, resolved on first use: the
models import ``parallel.mesh``, and ``dp`` imports the trainer and the
models, so importing them all here would be circular.
"""

_EXPORTS = {
    "make_mesh": "mesh", "split_batch": "mesh", "conformer_tp_spec": "mesh",
    "shard_params": "mesh", "gather_params": "mesh",
    "DataParallel": "dp", "ReplicaAveraging": "dp",
}
__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"),
                   name)
