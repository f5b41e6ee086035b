"""Device traces of a block of work.

Port of ``trace`` from ``cross_patient_speech_decoding_tpu/utils/
profiling.py``: ``jax.profiler``'s trace becomes a ``torch.profiler``
profile of the host and, where there is one, the CUDA card, written as a
Chrome/Perfetto trace file into the directory given.
"""

from __future__ import annotations

import contextlib
from pathlib import Path

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile a block onto disk: ``with trace('/tmp/prof'): step(...)``
    writes ``<log_dir>/trace.json`` (open it in Perfetto or
    chrome://tracing)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(out / "trace.json"))
