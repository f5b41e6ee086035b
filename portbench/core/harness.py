"""One run of one cell: set-up, the measured window, the check against
the plain reference, the result line.

    set-up  build the port's model from the benchmark's weights, make the
            inputs from the seed on the device, warm up the cell's own
            shapes (a training cell also takes its first, checked steps);
    window  ``--seconds`` of the cell's loop (``--trace 0``: the
            end-to-end metrics), or a traced run of the same length
            (``--trace 1``: the per-layer metrics, from spans, the
            profiler and the configuration's operation counts);
    check   after the window, with the peak memory read and the port's
            state freed: every number compared, beside its limit.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
import traceback

from portbench.core import spec

FORBIDDEN = ("jax", "jaxlib", "flax", "cross_patient_speech_decoding_tpu")


class Run:
    """The state of one run, shared by the loop's stages."""

    def __init__(self, cell, seed: int, seconds: float, device):
        self.cfg, self.traffic, self.limits = cell.config, cell.traffic, \
            cell.limits
        self.seed, self.seconds, self.device = int(seed), float(seconds), \
            device
        self.fam = spec.family(self.cfg)
        self.ref = spec.reference(self.cfg)
        self.loop = spec.loop(self.traffic)
        self.attempted, self.failed = 0, 0
        self.notes, self.stages = {}, {}
        self._t_mark = time.perf_counter()

    def note(self, **kw) -> None:
        """Numbers printed on earlier lines (launches, lateness, ...)."""
        self.notes.update(kw)

    def mark(self, stage: str, since: float | None = None) -> None:
        """Seconds of set-up since the last mark (or ``since``), as the
        stage ``stage``: the breakdown of ``setup_s`` on an earlier line."""
        t = time.perf_counter()
        self.stages[stage] = t - (self._t_mark if since is None else since)
        self._t_mark = t


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's, compared whole."""
    modules = sys.modules if modules is None else modules
    return sorted({m for m in modules if m.split(".")[0] in FORBIDDEN})


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             t_start: float) -> dict:
    """Everything but the printing; returns the result (its ``checks``
    last) and the run's notes under ``notes``."""
    import torch

    torch.set_num_threads(4)
    cuda = device.type == "cuda"
    run = Run(cell, seed, seconds, device)
    run.mark("imports", t_start)
    if cuda:
        torch.cuda.set_device(device)
        torch.empty(0, device=device)  # the context, before the reset
        torch.cuda.reset_peak_memory_stats(device)
    run.mark("context")
    run.loop.setup(run)
    # what set-up made lives to the end: a full collection would walk it
    # all (torch's and scipy's objects, some 10^5) and stall the window;
    # inside the window the collector does not run at all
    gc.collect()
    gc.freeze()
    run.mark("gc")
    setup_s = time.perf_counter() - t_start
    run.note(setup_stages_s=run.stages)
    gc.disable()
    try:
        if trace:
            rec = run.loop.traced(run, seconds)
        else:
            e2e = run.loop.window(run, seconds)
    finally:
        gc.enable()
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    run.loop.release(run)
    numbers = run.loop.numbers(run)
    missing = set(cell.limits) - set(numbers)
    if missing:
        raise KeyError(f"limits of numbers the loop has not: {missing}")
    checks = {name: {"value": numbers[name], "limit": limit}
              for name, limit in cell.limits.items()}
    run.note(unlimited={k: v for k, v in numbers.items()
                        if k not in cell.limits})
    correct = run.failed == 0 and all(c["value"] <= c["limit"]
                                      for c in checks.values())
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    if trace:
        metrics = {}
        for m in cell.per_layer:
            value = spec.reader(m["name"]).read(rec)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev["busy_s"], dev["window_s"] = rec["busy_s"], rec["window_s"]
    else:
        e2e["setup_s"] = setup_s
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    out = {"correct": bool(correct), "attempted": run.attempted,
           "failed": run.failed, "metrics": metrics, "device": dev}
    if trace:
        out["breakdown"] = rec["breakdown"]
    out["checks"] = checks
    out["notes"] = run.notes
    return out


def parse(argv):
    p = argparse.ArgumentParser(prog="portbench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv, t_start: float) -> int:
    args = parse(argv)
    try:
        cell = spec.load_cell(args.workload)
    except (OSError, KeyError, ValueError) as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} CUDA card(s); "
              f"available: {torch.cuda.is_available()}, count "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    try:
        out = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                       torch.device("cuda", 0), t_start)
    except Exception:  # the run has no result: say why, print none
        traceback.print_exc()
        return 1
    bad = forbidden_modules()
    if bad:
        print(f"portbench: JAX or the JAX package loaded: {bad}",
              file=sys.stderr)
        return 3
    from portbench.core.peaks import card_power

    notes = out.pop("notes")
    print(json.dumps(finite({"card": card_power(), **notes})), flush=True)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(finite(out)), flush=True)
    return 0


def finite(obj):
    """The object with every non-finite float written as a string, so that
    the line stays JSON."""
    if isinstance(obj, float) and not abs(obj) < float("inf"):
        return repr(obj)
    if isinstance(obj, dict):
        return {k: finite(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [finite(v) for v in obj]
    return obj
