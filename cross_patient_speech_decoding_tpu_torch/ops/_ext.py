"""Build and bind the hand-written CUDA kernels of ``ops/csrc``.

Each source is compiled with ``nvcc`` into a shared library of its own
with a plain C interface, loaded with ``ctypes``, at first use; the
compilers of all sources run at the same time. A library lands in
``cross_patient_speech_decoding_tpu_torch/_build/`` under a name keyed by
the hash of its source, the shared headers and the flags, so a changed
source is rebuilt and an unchanged one is reused. Nothing here runs at
import: the CPU tests import every module on machines without ``nvcc``.
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
from types import SimpleNamespace

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
# every local header a source includes (tests/test_torch_package.py checks
# the list against the sources): each enters every library's hash
HEADERS = ("gru_mma.cuh", "gru_tile.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int
_LLP = ctypes.POINTER(_LL)
# x, sx_t, sx_b, x_bf16: a GRU layer's input, its time and batch strides
# and its dtype (bf16 where set, else float32)
_X = (_P, _LL, _LL, _I)
# source -> {exported function: argtypes}; every exported function returns
# a cudaError_t as int (0 = success)
SOURCES = {
    "gru_fwd.cu": {
        # n_rows, F, H, n (out: floats of the wimg scratch)
        "gru_fwd_wimg": (_LL, _I, _I, _LLP),
        # counts (out: weight products on wgmma, on mma.sync, then step
        # launches whose cluster split K over 1, 2, 4, 8 CTAs), reset
        "gru_fwd_counts": (_LLP, _I),
        # x..., h0, wi, bi, wh, bh, hs, gi, wimg, T, B, F, H, reverse, stream
        "gru_fwd": _X + (_P,) * 8 + (_I,) * 5 + (_P,),
        # x..., h0, wi, bi, wh, bh of each direction, hs_f, hs_b, gi, wimg,
        # T, B, F, H, stream
        "gru_bifwd": _X + (_P,) * 14 + (_I,) * 4 + (_P,),
    },
    "gru_bwd.cu": {
        # n_steps, B, F, H, need_dx, part, wimg (out: floats of the two
        # scratches)
        "gru_bwd_sizes": (_I,) * 5 + (_LLP, _LLP),
        # counts (out: weight products on wgmma, on mma.sync, then the
        # sweep's step launches whose cluster split K over 1, 2, 4, 8, 16
        # CTAs), reset
        "gru_bwd_counts": (_LLP, _I),
        # x..., hprev, dhs, wi, bi, wh, bh, g, dhz, dh0, dx, part, dwi, dwh,
        # wimg, T, B, F, H, reverse, stream
        "gru_bwd": _X + (_P,) * 14 + (_I,) * 5 + (_P,),
        # dxw, dx, T, B, C, win, stride, n_win, stream
        "gru_fold_windows": (_P, _P) + (_I,) * 6 + (_P,),
    },
    "jacobi.cu": {
        # A, w, V, n_sweeps, B, Kp, sweeps, stream
        "jacobi_eigh_f32": (_P, _P, _P, _P, _I, _I, _I, _P),
    },
}

_lock = threading.Lock()
_lib: SimpleNamespace | None = None


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


def library_path(source: str, defines=()) -> Path:
    """Where the library of ``source`` (a key of ``SOURCES``) is built;
    ``defines`` (``"NAME=value"`` strings) build a variant of it."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update("\n".join(defines).encode())
    for name in (source, *HEADERS):
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"lib{Path(source).stem}_{h.hexdigest()[:16]}.so"


def build(verbose: bool = False, defines=(), sources=None) -> float:
    """Compile the sources (default: all) whose library is missing, one
    ``nvcc`` each, all started together, with the preprocessor
    ``defines`` of a variant (the tuning macros of ``gru_mma.cuh``).

    Returns the seconds spent compiling (0.0 when all are reused). Raises
    ``RuntimeError`` with the compiler's output when an nvcc fails.
    """
    sources = list(SOURCES) if sources is None else list(sources)
    todo = [s for s in sources if not library_path(s, defines).exists()]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    jobs = []
    wrappers = []
    try:
        for source in todo:
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            src = str(CSRC / source)
            if defines:
                # a source that defines, then includes: nvcc's -D splits
                # its value at commas, and a tile shape has them
                fd, src = tempfile.mkstemp(suffix=".cu", dir=BUILD_DIR)
                wrappers.append(src)
                with os.fdopen(fd, "w") as f:
                    f.writelines(f"#define {d.replace('=', ' ', 1)}\n"
                                 for d in defines)
                    f.write(f'#include "{CSRC / source}"\n')
            cmd = [_nvcc(), *NVCC_FLAGS,
                   *(["-Xptxas", "-v"] if verbose else []),
                   "-o", tmp, src]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            jobs.append((source, tmp, cmd, proc))
        failed = []
        for source, tmp, cmd, proc in jobs:
            out, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}): "
                              f"{' '.join(cmd)}\n{out}")
                continue
            if verbose:
                print(f"[{source}]\n{out}", flush=True)
            # atomic: a reader never sees a partial file
            os.replace(tmp, library_path(source, defines))
        if failed:
            raise RuntimeError("\n".join(failed))
    finally:
        for _, tmp, _, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.unlink(tmp)
        for src in wrappers:
            os.unlink(src)
    return time.perf_counter() - t0


def load(defines=(), sources=None) -> SimpleNamespace:
    """Build (where missing) and load the libraries of ``sources``
    (default: all) with ``defines``: their exported functions as
    attributes."""
    sources = list(SOURCES) if sources is None else list(sources)
    build(defines=defines, sources=sources)
    fns = {}
    for source in sources:
        cdll = ctypes.CDLL(str(library_path(source, defines)))
        for name, argtypes in SOURCES[source].items():
            fn = getattr(cdll, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
            fns[name] = fn
    return SimpleNamespace(**fns)


def lib() -> SimpleNamespace:
    """The exported functions of every kernel library, built on first use,
    as attributes (``lib().gru_fwd``)."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = load()
        return _lib


def loaded() -> bool:
    """Whether the libraries are loaded (``lib`` has run): reading a
    kernel library's counters never builds it."""
    return _lib is not None


def check(err: int, name: str) -> None:
    """Raise if a kernel entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
