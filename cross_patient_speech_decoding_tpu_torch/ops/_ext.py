"""Build and bind the hand-written CUDA kernels of ``ops/csrc``.

The sources are compiled with ``nvcc`` into a shared library with a plain C
interface, loaded with ``ctypes``, at first use. The library lands in
``cross_patient_speech_decoding_tpu_torch/_build/`` under a name keyed by
the hash of the source and the flags, so a changed source is rebuilt and
an unchanged one is reused. Nothing here runs at import: the CPU tests
import every module on machines without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
SOURCES = ("gru_fwd.cu",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int
# every exported function returns a cudaError_t as int (0 = success)
SIGNATURES = {
    # x, sx_t, sx_b, h0, wi, bi, wh, bh, hs, T, B, F, H, reverse, stream
    "gru_fwd_f32": (_P, _LL, _LL, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                    _I, _P),
    "gru_fwd_bf16": (_P, _LL, _LL, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                     _I, _P),
    # x, sx_b, C, win, stride, h0, wi, bi, wh, bh, hs, n_win, B, H, stream
    "gru_wfwd_bf16": (_P, _LL, _I, _I, _I, _P, _P, _P, _P, _P, _P, _I, _I,
                      _I, _P),
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    """The CUDA compiler: on PATH, else under CUDA_HOME (default
    /usr/local/cuda, the toolkit's standard prefix)."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cand = Path(home or "/usr/local/cuda") / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME): the CUDA kernels cannot be built"
    )


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"libcpsd_kernels_{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> float:
    """Compile the kernels if the library for this source is missing.

    Returns the seconds spent compiling (0.0 when reused). Raises
    ``RuntimeError`` with the compiler's output when nvcc fails.
    """
    out = library_path()
    if out.exists():
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", tmp, *(str(CSRC / s) for s in SOURCES)]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                f"{proc.stdout}\n{proc.stderr}"
            )
        if verbose:
            print(proc.stdout + proc.stderr, flush=True)
        os.replace(tmp, out)  # atomic: a reader never sees a partial file
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return time.perf_counter() - t0


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            build()
            cdll = ctypes.CDLL(str(library_path()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(cdll, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            _lib = cdll
        return _lib


def check(err: int, name: str) -> None:
    """Raise if a kernel entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
