"""The native host core of mixture synthesis (``csrc/mixcore.cpp``): its
build, its ctypes bindings, and its counters.

The port's own copy of ``css_tpu/native/__init__.py``: the same entry
points (``mix_and_window``, ``mix_and_window_k``, ``fft_convolve_trunc``,
``add_noise_snr``), C signatures and ABI version. The source is compiled
with ``g++`` at first use into ``css_tpu_torch/_build/`` (git-ignored),
named by a hash of the source and the flags, under a lock and through a
temporary name moved into place with ``os.replace``, as ``_build.py``
builds the CUDA kernels. Nothing is built or loaded at import.

The switch semantics are the JAX package's: a mixer or augmentation asked
for the native path takes it when the library builds and loads, and the
numpy path otherwise (no toolchain is needed to train). Unlike the JAX
package, the fall-back is counted: ``native.fallbacks`` counts the calls
that asked for the native path and ran numpy, and ``native.calls`` the
calls into the library, so that a run can be held to no fall-back. Why the
library is unavailable is kept in ``native.error``.

The flags are portable (no ``-march=native``) and keep float contraction
off, so one build gives the same bits on every x86-64 host.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from css_tpu_torch.ops._build import BUILD_DIR, CSRC

SOURCE = CSRC / "mixcore.cpp"
CXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17", "-ffp-contract=off"]
ABI = 3

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False
calls = 0
fallbacks = 0
error: Optional[str] = None


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libmixcore_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``csrc/mixcore.cpp`` with g++ (``$CXX`` if set) unless the
    library of this source and these flags exists; returns its path."""
    so = library_path()
    if so.exists():
        return so
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("g++ not found on PATH (and $CXX unset): the "
                           "native mixing core cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="build_", dir=BUILD_DIR))
    try:
        tmp_so = tmp / so.name
        res = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp_so),
                              str(SOURCE)], stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True, timeout=300)
        if res.returncode != 0:
            raise RuntimeError(f"g++ failed on {SOURCE.name}:\n{res.stdout}")
        os.replace(tmp_so, so)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return so


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    f32p = ctypes.POINTER(ctypes.c_float)
    i64p = ctypes.POINTER(ctypes.c_int64)
    i64, i32 = ctypes.c_int64, ctypes.c_int32
    lib.mix_and_window.argtypes = [f32p, i64, f32p, i64, i64, i64, i64,
                                   f32p, f32p, f32p]
    lib.mix_and_window_k.argtypes = [f32p, i64p, i64p, i64, i64, i64,
                                     f32p, f32p]
    lib.fft_convolve_trunc.argtypes = [f32p, i64, f32p, i64, i32, f32p]
    lib.fft_convolve_trunc_cached.argtypes = [f32p, i64, f32p, i64, i64,
                                              i32, f32p]
    lib.add_noise_snr.argtypes = [f32p, i64, f32p, i64, i64, ctypes.c_float]
    lib.mixcore_abi_version.restype = i32
    return lib


def load() -> Optional[ctypes.CDLL]:
    """Build if needed and load once; None (the reason in ``error``) when
    the library cannot be built or loaded."""
    global _LIB, _TRIED, error
    with _LOCK:
        if not _TRIED:
            _TRIED = True
            try:
                lib = _bind(ctypes.CDLL(str(build())))
                if lib.mixcore_abi_version() != ABI:
                    raise RuntimeError(
                        f"mixcore ABI {lib.mixcore_abi_version()} != {ABI}")
                _LIB = lib
            except (OSError, RuntimeError, subprocess.SubprocessError) as e:
                error = f"{type(e).__name__}: {e}"
        return _LIB


def available() -> bool:
    return load() is not None


def count_fallback() -> None:
    """A caller asked for the native path and runs numpy instead."""
    global fallbacks
    fallbacks += 1


def _lib() -> ctypes.CDLL:
    global calls
    lib = load()
    if lib is None:
        raise RuntimeError(f"native mixing core unavailable: {error}")
    calls += 1
    return lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def mix_and_window(w1: np.ndarray, w2: np.ndarray, offset: int, win: int,
                   num_windows: int):
    """Returns (mix, s1, s2), each (num_windows, win) float32."""
    lib = _lib()
    w1 = np.ascontiguousarray(w1, np.float32)
    w2 = np.ascontiguousarray(w2, np.float32)
    mix = np.empty((num_windows, win), np.float32)
    s1 = np.empty((num_windows, win), np.float32)
    s2 = np.empty((num_windows, win), np.float32)
    lib.mix_and_window(_ptr(w1), len(w1), _ptr(w2), len(w2), offset, win,
                       num_windows, _ptr(mix), _ptr(s1), _ptr(s2))
    return mix, s1, s2


def mix_and_window_k(waves, offsets, win: int, num_windows: int):
    """K-speaker mixing: ``waves`` is a list of K 1-D utterances, each
    placed at ``offsets[i]`` of the mixture timeline. Returns
    (mix (num_windows, win), srcs (K, num_windows, win))."""
    lib = _lib()
    k = len(waves)
    waves = [np.ascontiguousarray(w, np.float32) for w in waves]
    concat = (np.concatenate(waves) if k > 1
              else np.ascontiguousarray(waves[0]))
    lens = np.asarray([len(w) for w in waves], np.int64)
    offs = np.asarray(offsets, np.int64)
    mix = np.empty((num_windows, win), np.float32)
    srcs = np.empty((k, num_windows, win), np.float32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.mix_and_window_k(_ptr(concat), lens.ctypes.data_as(i64p),
                         offs.ctypes.data_as(i64p), k, win, num_windows,
                         _ptr(mix), _ptr(srcs))
    return mix, srcs


def fft_convolve_trunc(x: np.ndarray, h: np.ndarray, normalize: bool = True,
                       rir_id: Optional[int] = None) -> np.ndarray:
    """FFT convolution truncated to len(x). With a stable ``rir_id`` (a
    fixed RIR pool) the RIR's spectrum is computed once per process."""
    lib = _lib()
    x = np.ascontiguousarray(x, np.float32)
    h = np.ascontiguousarray(h, np.float32)
    out = np.empty(len(x), np.float32)
    if rir_id is None:
        lib.fft_convolve_trunc(_ptr(x), len(x), _ptr(h), len(h),
                               1 if normalize else 0, _ptr(out))
    else:
        lib.fft_convolve_trunc_cached(_ptr(x), len(x), _ptr(h), len(h),
                                      int(rir_id), 1 if normalize else 0,
                                      _ptr(out))
    return out


def add_noise_snr(wav: np.ndarray, noise: np.ndarray, start: int,
                  snr_db: float) -> np.ndarray:
    """wav plus the noise (tiled from ``start``) scaled to ``snr_db``."""
    lib = _lib()
    wav = np.ascontiguousarray(wav, np.float32).copy()
    noise = np.ascontiguousarray(noise, np.float32)
    lib.add_noise_snr(_ptr(wav), len(wav), _ptr(noise), len(noise),
                      start, snr_db)
    return wav
