"""Build the CUDA kernels under ``csrc/`` into one shared library, and the
launch helpers the kernel wrappers share: the package's one operator
library and the launch counters.

The sources have a plain C interface (no PyTorch headers), so each one
compiles with ``nvcc`` in seconds; all are compiled at once, in parallel,
then linked into one ``.so`` that is loaded with ``ctypes``. Nothing is
built or loaded when this module is imported: ``load_library()`` does it at
the first kernel launch.

The library lands in ``css_tpu_torch/_build/`` (git-ignored), named by a
hash of the sources and flags, so an edited source is rebuilt and a
finished build is reused. Every file is written under a temporary name and
moved into place with ``os.replace``, so concurrent builders never see a
partial library.

``LIB`` holds the kernels that ``torch.export`` keeps as one node (K2, KC,
KN), each defined with a CPU kernel (the plain version), a CUDA kernel
(the launch) and a fake kernel. Not with ``torch.library``'s ``custom_op``,
whose first call imports ``torch._dynamo``: seconds of set-up.

``@counted`` registers a kernel wrapper in ``KERNELS`` with its counters
``launches`` and ``plain_routes``. Launch code counts through ``KERNELS``,
so a count lands on the registered wrapper whatever a module attribute
holds; ``utils/programs.py`` adds a captured graph's counts at each replay.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Callable, Dict

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
DEFAULT_NVCC = "/usr/local/cuda/bin/nvcc"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry point -> argtypes (every pointer and the stream as c_void_p, or
# ctypes would pass them as 32-bit ints)
SIGNATURES = {
    "css_istft": [_P] * 5 + [_I] * 5 + [_P],
    "css_stft_mag": [_P] * 4 + [_I] * 7 + [_P],
    "css_lstm": [_P] * 8 + [_I] * 13 + [_P],
    "css_conv_module": [_P] * 14 + [_I] * 5 + [_F] * 2 + [_I] * 2 + [_P],
    "css_add_layer_norm": [_P] * 6 + [_I] * 2 + [_F] * 2 + [_I] * 2 + [_P],
}


LIB = torch.library.Library("css_tpu_torch", "FRAGMENT")
KERNELS: Dict[str, Callable] = {}  # name -> the wrapper that counts


def counted(fn: Callable) -> Callable:
    """Register the kernel wrapper ``fn`` under its name, its counters
    ``fn.launches`` and ``fn.plain_routes`` at 0 (a decorator)."""
    fn.launches = fn.plain_routes = 0
    KERNELS[fn.__name__] = fn
    return fn


def find_nvcc() -> str:
    """nvcc from $CUDA_HOME/bin, then PATH, then /usr/local/cuda/bin."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(str(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc"))
    cands.append(shutil.which("nvcc"))
    cands.append(DEFAULT_NVCC)
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
        "/usr/local/cuda/bin): the CUDA kernels of css_tpu_torch are built "
        "on the machine with the card; on the CPU the plain versions run")


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libcss_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile every ``csrc/*.cu`` (in parallel) and link one library;
    returns its path. Compiler output (``-Xptxas -v``: registers, shared
    memory, spills per kernel) is kept beside it in ``<lib>.log``."""
    so = library_path()
    if so.exists():
        return so
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="build_", dir=BUILD_DIR))
    try:
        cus = sorted(CSRC.glob("*.cu"))
        procs = []
        for cu in cus:
            obj = tmp / (cu.stem + ".o")
            procs.append((cu, obj, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(cu), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        log = []
        failed = []
        for cu, _, p in procs:
            out, _ = p.communicate()
            log.append(f"== {cu.name}\n{out}")
            if p.returncode != 0:
                failed.append(cu.name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
        tmp_so = tmp / so.name
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp_so),
             *[str(obj) for _, obj, _ in procs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        tmp_log = tmp / "build.log"
        tmp_log.write_text("\n".join(log))
        os.replace(tmp_log, so.with_suffix(".log"))
        os.replace(tmp_so, so)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return so


@functools.lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    """Build if needed, load once, and declare every entry point's types."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def split_rows(n: int, limit: int) -> list:
    """[start, stop) ranges of at most ``limit`` consecutive rows, as even
    as possible, covering ``range(n)``: one launch each, for a kernel whose
    rows (batch entries) are independent and whose launch takes at most
    ``limit`` of them. No range for n == 0."""
    if limit < 1:
        raise ValueError(f"split_rows: limit {limit} < 1")
    parts = -(-n // limit)
    return [(n * i // parts, n * (i + 1) // parts) for i in range(parts)]


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
