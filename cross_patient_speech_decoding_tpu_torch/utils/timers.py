"""Wall-clock timing helpers for benchmarking device work.

Port of ``cross_patient_speech_decoding_tpu/utils/timers.py``: where the
JAX package calls ``block_until_ready`` on a result's leaves, the port
synchronises the CUDA device of every tensor in the result (nested tuples,
lists and dicts). CPU tensors need no synchronisation.
"""

from __future__ import annotations

import time

import numpy as np
import torch


class Timer:
    """Context-managed wall clock timer (seconds)."""

    def __enter__(self):
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self.start
        return False


def _tensors(tree):
    if torch.is_tensor(tree):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def _block(tree) -> None:
    """Wait for the CUDA devices of the tensors in ``tree``."""
    for dev in {t.device for t in _tensors(tree) if t.is_cuda}:
        torch.cuda.synchronize(dev)


def median_ms(fn, *args, warmup: int = 2, iters: int = 20) -> float:
    """Median latency in ms of ``fn(*args)``, each call synchronised on the
    CUDA devices of the tensors it returns."""
    for _ in range(warmup):
        _block(fn(*args))
    samples = []
    for _ in range(iters):
        t0 = time.perf_counter()
        _block(fn(*args))
        samples.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(samples))
