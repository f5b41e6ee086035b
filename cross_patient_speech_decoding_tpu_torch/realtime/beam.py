"""CTC prefix beam search and batched edit distance on the host: the C++
of ``native/beam.cpp`` through ``ctypes``, with a Python fallback.

Port of ``cross_patient_speech_decoding_tpu/realtime/beam.py``. The
library is compiled with ``g++`` from ``native/beam.cpp`` at first use
into ``cross_patient_speech_decoding_tpu_torch/_build/`` (which git
ignores), under a name keyed by the hash of the source and the flags;
``native/`` itself is never written. Where the source or a compiler is
missing, or the build fails, both functions run their Python versions
(``ops.ctc.prefix_beam_search``, :func:`_py_edit`), as in the JAX
package; :func:`native_available` says which is taken.
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

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "native" / "beam.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_LIB = None
_TRIED = False


def library_path() -> Path:
    """Where the library of :data:`SOURCE` is built."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libcpsd_native_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile :data:`SOURCE` with g++ unless its library exists; returns
    the library's path. Raises ``RuntimeError`` with the compiler's output
    when the build fails, ``FileNotFoundError`` without g++."""
    path = library_path()
    if path.exists():
        return path
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise FileNotFoundError("no C++ compiler (g++, c++) on PATH")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, str(SOURCE)],
                              capture_output=True, text=True, timeout=120)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, path)  # atomic: a reader never sees a partial file
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def _load():
    """The bound library, built on first use; None where it cannot be."""
    global _LIB, _TRIED
    with _lock:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        try:
            path = build()
        except (OSError, RuntimeError, subprocess.TimeoutExpired):
            return None
        lib = ctypes.CDLL(str(path))
        lib.prefix_beam_search.restype = ctypes.c_int
        lib.prefix_beam_search.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_double),
        ]
        lib.edit_distance_batch.restype = None
        lib.edit_distance_batch.argtypes = [
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32),
        ]
        _LIB = lib
        return lib


def native_available() -> bool:
    """True when the C++ library is built and bound."""
    return _load() is not None


def prefix_beam_search(log_probs: np.ndarray, beam_size: int = 100,
                       blank: int = 0):
    """CTC prefix beam search; native C++ when available, Python otherwise.

    Args:
        log_probs: (T, V) log probabilities.

    Returns:
        (sequence tuple, negative log likelihood).
    """
    lib = _load()
    if lib is None:
        from cross_patient_speech_decoding_tpu_torch.ops.ctc import (
            prefix_beam_search as py_pbs,
        )

        return py_pbs(np.asarray(log_probs), beam_size, blank)

    lp = np.ascontiguousarray(log_probs, np.float32)
    T, V = lp.shape
    out = np.zeros(T, np.int32)
    nll = ctypes.c_double()
    n = lib.prefix_beam_search(
        lp.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), T, V,
        beam_size, blank,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.byref(nll),
    )
    return tuple(int(s) for s in out[:n]), float(nll.value)


def edit_distance_batch(preds, pred_lens, targets, target_lens):
    """Batched Levenshtein distance of (B, P) predictions and (B, L)
    targets over their valid lengths; native C++ when available."""
    preds = np.ascontiguousarray(preds, np.int32)
    targets = np.ascontiguousarray(targets, np.int32)
    pred_lens = np.ascontiguousarray(pred_lens, np.int32)
    target_lens = np.ascontiguousarray(target_lens, np.int32)
    B, P = preds.shape
    L = targets.shape[1]
    if not (len(pred_lens) == len(target_lens) == targets.shape[0] == B):
        raise ValueError("preds, targets and their lengths must share B")
    if pred_lens.size and (pred_lens.min() < 0 or pred_lens.max() > P
                           or target_lens.min() < 0
                           or target_lens.max() > L):
        raise ValueError("a length lies outside its row")

    out = np.zeros(B, np.int32)
    lib = _load()
    if lib is None:
        for b in range(B):
            out[b] = _py_edit(preds[b, : pred_lens[b]],
                              targets[b, : target_lens[b]])
        return out
    lib.edit_distance_batch(
        preds.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        pred_lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        targets.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        target_lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        B, P, L,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return out


def _py_edit(a, b):
    """Levenshtein distance of two 1-D sequences (the fallback)."""
    dp = np.arange(len(b) + 1)
    for x in a:
        prev = dp.copy()
        dp[0] += 1
        for j, y in enumerate(b):
            dp[j + 1] = min(prev[j + 1] + 1, dp[j] + 1, prev[j] + (x != y))
    return dp[len(b)]
