"""Spans the benchmark records around the port's layers, and the reduction
of a ``torch.profiler`` trace to busy time, idle gaps and top operations.

Module spans come from PyTorch's public module hooks (forward pre/post,
full backward pre/post) on the submodules a configuration names, with a
CUDA event at each boundary; they never select work by kernel name, so
they read the same work whatever kernels run under the module.
"""

from __future__ import annotations

import time
from contextlib import contextmanager


class ModuleSpans:
    """CUDA events at the forward (and, with ``backward``, the backward)
    boundaries of each named submodule; on a CPU model, host clocks."""

    def __init__(self, model, names, backward: bool):
        import torch

        self._torch = torch
        self.cuda = next(model.parameters()).device.type == "cuda"
        self.spans = []  # [module name, phase, start mark, end mark]
        self._open = {}
        self._handles = []
        for name in names:
            mod = model.get_submodule(name)
            self._handles.append(mod.register_forward_pre_hook(
                self._start(name, "fwd")))
            self._handles.append(mod.register_forward_hook(
                self._end(name, "fwd")))
            if backward:
                self._handles.append(mod.register_full_backward_pre_hook(
                    self._start(name, "bwd")))
                self._handles.append(mod.register_full_backward_hook(
                    self._end(name, "bwd")))

    def _mark(self):
        if self.cuda:
            ev = self._torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def _start(self, name, phase):
        def hook(*_):
            self._open.setdefault((name, phase), []).append(self._mark())
        return hook

    def _end(self, name, phase):
        def hook(*_):
            start = self._open[(name, phase)].pop()
            self.spans.append([name, phase, start, self._mark()])
        return hook

    def close(self):
        """Remove the hooks and return [(module, phase, ms)]."""
        for h in self._handles:
            h.remove()
        if self.cuda:
            self._torch.cuda.synchronize()
            return [(n, p, s.elapsed_time(e)) for n, p, s, e in self.spans]
        return [(n, p, (e - s) * 1e3) for n, p, s, e in self.spans]


@contextmanager
def profiled(device):
    """``torch.profiler`` over the block, CPU and (on a card) CUDA
    activity; yields a dict that holds the reduced events afterwards:
    ``device`` [(name, start_s, end_s)], ``host`` [(name, start_s,
    end_s)] on one clock."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    out = {}
    with profile(activities=acts) as prof:
        yield out
        if device.type == "cuda":
            with torch.profiler.record_function("sync"):
                torch.cuda.synchronize()
    out.update(_events(prof))


def _events(prof) -> dict:
    from torch.autograd import DeviceType

    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        s, d = e.start_ns(), e.duration_ns()
        rec = (e.name(), s * 1e-9, (s + d) * 1e-9)
        if e.device_type() != DeviceType.CUDA:
            host.append(rec)
        elif not e.is_user_annotation():
            # a host range mirrored on the device's timeline is no work
            dev.append(rec)
    return {"device": dev, "host": host}


def short_name(name: str) -> str:
    """A kernel's name without 'void', its arguments and namespaces."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    return name.split("(")[0].strip()[:120]


def ranges(host, label: str):
    """The (start, end) of every host range recorded as ``label``."""
    return [(s, e) for n, s, e in host if n == label]


def top_ops(device_events, lo: float, hi: float, n: int = 10):
    """The device operations that took most time in [lo, hi], as
    [[name, seconds]]."""
    total = {}
    for name, s, e in device_events:
        s, e = max(s, lo), min(e, hi)
        if e > s:
            key = short_name(name)
            total[key] = total.get(key, 0.0) + (e - s)
    return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])
            [:n]]


def idle_gaps(device_events, host, lo: float, hi: float, skip=(),
              n: int = 10):
    """The ``n`` longest stretches of [lo, hi] with no device operation,
    each named by the host operation that overlaps it most (the shortest
    such on a tie), as [[name, seconds]]. Host ranges named in ``skip``
    (the benchmark's own wrappers) name no gap."""
    from portbench.core.stats import gaps

    longest = sorted(gaps([(s, e) for _, s, e in device_events], lo, hi),
                     key=lambda g: g[0] - g[1])[:n]
    out = []
    for gs, ge in longest:
        best, key = "no host operation", None
        for name, s, e in host:
            ov = min(e, ge) - max(s, gs)
            if ov <= 0 or name in skip:
                continue
            k = (ov, -(e - s))
            if key is None or k > key:
                best, key = name, k
        out.append([best, ge - gs])
    return out
